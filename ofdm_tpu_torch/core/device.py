"""Where an entry point puts data that arrives from the host.

A tensor argument keeps its device: the caller chose it.  Bytes, a
bytearray or a numpy array carry no device, so ``encode`` and ``decode``
put them on CUDA unless the caller passes ``device=``; where CUDA is absent
that raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device, CUDA when it is None.  Raises
    RuntimeError for a CUDA device on a host without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ofdm_tpu_torch puts host input on CUDA by default, and CUDA is "
            "not available here; pass device=\"cpu\" to run on the CPU")
    return dev


def place(x: torch.Tensor, device) -> torch.Tensor:
    """A tensor argument on ``device``, or on its own device when that is
    None."""
    return x if device is None else x.to(resolve(device))


def as_tensor(x, device) -> torch.Tensor:
    """A tensor kept on its own device (or moved to ``device``), or an array
    put on ``device`` (CUDA when None)."""
    if isinstance(x, torch.Tensor):
        return place(x, device)
    return torch.as_tensor(np.asarray(x)).to(resolve(device))
