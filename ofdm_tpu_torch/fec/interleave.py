"""Block interleaving between FEC and the modem (port of
ofdm_tpu/fec/interleave.py).

A rows x cols block interleaver spreads each codeword's bytes across the
frame, so a burst of corrupted symbols lands a few bytes in many codewords
instead of many bytes in one.  ``interleave`` / ``deinterleave`` are the
host (numpy) forms, copied from the JAX package; the ``_device`` forms run
in torch on the input tensor's device, batched over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def interleave(data: np.ndarray, depth: int) -> np.ndarray:
    """Write row-major into a [depth, ceil(n/depth)] grid (zero-padded),
    read column-major.  depth = number of codewords interleaved."""
    arr = np.asarray(data, dtype=np.uint8)
    n = arr.size
    cols = -(-n // depth)
    grid = np.zeros(depth * cols, dtype=np.uint8)
    grid[:n] = arr
    return grid.reshape(depth, cols).T.reshape(-1)


def deinterleave(data: np.ndarray, depth: int, n: int | None = None) -> np.ndarray:
    """Inverse of :func:`interleave`; ``n`` trims the zero padding."""
    arr = np.asarray(data, dtype=np.uint8)
    cols = arr.size // depth
    out = arr.reshape(cols, depth).T.reshape(-1)
    return out[: n if n is not None else out.size]


def interleave_device(data, depth: int) -> torch.Tensor:
    """:func:`interleave` on the tensor's device, batched over leading axes
    (a numpy array becomes a CPU tensor)."""
    arr = torch.as_tensor(data)
    n = arr.shape[-1]
    cols = -(-n // depth)
    pad = depth * cols - n
    if pad:
        arr = F.pad(arr, (0, pad))
    grid = arr.reshape(*arr.shape[:-1], depth, cols)
    return grid.transpose(-1, -2).reshape(*arr.shape[:-1], depth * cols)


def deinterleave_device(data, depth: int, n: int | None = None) -> torch.Tensor:
    """:func:`deinterleave` on the tensor's device, batched over leading
    axes."""
    arr = torch.as_tensor(data)
    cols = arr.shape[-1] // depth
    out = arr.reshape(*arr.shape[:-1], cols, depth).transpose(-1, -2).reshape(
        *arr.shape[:-1], cols * depth)
    return out[..., : n if n is not None else out.shape[-1]]
