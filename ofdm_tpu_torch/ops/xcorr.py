"""Frame synchronization by sliding correlation (port of ofdm_tpu/ops/xcorr.py).

The locking template is at most 128 taps, so the correlation
c[lag] = sum_j s[lag + j] conj(tpl[j]) is computed for every lag at once as
one matmul: stride-128 frames of 256 samples against a banded Toeplitz of
the template.  A peak at lag k gives the reference's offset k - 1
(src/receiver.rs:20-25).  This module is the plain version behind the
``sync_align`` kernel (kernels/align.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .fft import device_table

MAX_TAPS = 128


def _template_is_real(tpl: np.ndarray) -> bool:
    return not np.iscomplexobj(tpl) or not np.any(tpl.imag)


def template_key(tpl) -> bytes:
    """Hashable form of a template for the cached Toeplitz builders (widened
    to complex128, which is exact for complex64 input)."""
    return np.asarray(tpl).astype(np.complex128).tobytes()


@lru_cache(maxsize=None)
def _toeplitz_template(key: bytes, dtype_name: str) -> np.ndarray:
    """Packed banded Toeplitz of the conjugated template, W[512, 256]:
    [frames_re | frames_im] @ W = [c_re | c_im] for 128 lags per frame."""
    t = np.frombuffer(key, dtype=np.complex128)
    k = t.shape[0]
    tr = np.zeros((256, 128))
    ti = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
        ti[b:b + k, b] = t.imag
    return np.block([[tr, -ti], [ti, tr]]).astype(dtype_name)


@lru_cache(maxsize=None)
def _toeplitz_template_real(key: bytes, dtype_name: str) -> np.ndarray:
    """Real-template banded Toeplitz Tr[256, 128]: frames_re @ Tr = c_re and
    frames_im @ Tr = c_im, half the MACs of the packed complex form."""
    t = np.frombuffer(key, dtype=np.complex128)
    k = t.shape[0]
    tr = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
    return tr.astype(dtype_name)


def sliding_correlation_matmul(samples: torch.Tensor, template) -> torch.Tensor:
    """c[lag] = sum_j samples[lag+j] * conj(template[j]) for lag in [0, T-1]
    (samples past T read as zero).  samples: complex[B, T] or [T]."""
    squeeze = samples.dim() == 1
    if squeeze:
        samples = samples[None, :]
    b, t = samples.shape
    tpl = np.asarray(template)
    if tpl.shape[-1] > MAX_TAPS:
        raise NotImplementedError(
            f"matmul correlation supports templates up to {MAX_TAPS} taps")
    rd = torch.float64 if samples.dtype == torch.complex128 else torch.float32
    name = "float64" if rd == torch.float64 else "float32"
    key = template_key(tpl)

    n_frames = -(-t // 128)
    pad = n_frames * 128 + 256 - t
    x = torch.view_as_real(samples)                          # [b, t, 2]
    x = torch.cat([x, x.new_zeros((b, pad, 2))], dim=1)
    blocks_re = x[..., 0].reshape(b, -1, 128)
    blocks_im = x[..., 1].reshape(b, -1, 128)
    if _template_is_real(tpl):
        w = device_table(_toeplitz_template_real, (key, name), rd,
                         samples.device)
        frames = torch.cat([
            torch.stack([blocks_re[:, :-1], blocks_im[:, :-1]], dim=1),
            torch.stack([blocks_re[:, 1:], blocks_im[:, 1:]], dim=1),
        ], dim=-1)[:, :, :n_frames]                          # [b, 2, nf, 256]
        out = frames @ w
        c = torch.complex(out[:, 0].reshape(b, -1)[:, :t],
                          out[:, 1].reshape(b, -1)[:, :t])
        return c[0] if squeeze else c
    w = device_table(_toeplitz_template, (key, name), rd, samples.device)
    frames = torch.cat([blocks_re[:, :-1], blocks_re[:, 1:],
                        blocks_im[:, :-1], blocks_im[:, 1:]],
                       dim=-1)[:, :n_frames]
    out = frames @ w
    c = torch.complex(out[..., :128].reshape(b, -1)[:, :t],
                      out[..., 128:].reshape(b, -1)[:, :t])
    return c[0] if squeeze else c


def locking_sync_offset(samples: torch.Tensor, template) -> torch.Tensor:
    """Frame-sync offset with reference semantics: the first-occurrence
    argmax of the correlation power over lags >= 0, minus 1.  Batched over
    leading axes; int64."""
    c = sliding_correlation_matmul(samples, template)
    power = c.real ** 2 + c.imag ** 2
    return torch.argmax(power, dim=-1) - 1
