"""fftshift/ifftshift (port of ofdm_tpu/ops/shift.py) with the reference's
split-at-mid semantics (src/signals/mod.rs:61-95), which coincide with
numpy's for all lengths."""

from __future__ import annotations

import torch


def fft_shift(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    mid = (x.shape[axis] + 1) // 2
    return torch.roll(x, -mid, dims=axis)


def ifft_shift(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    mid = x.shape[axis] // 2
    return torch.roll(x, -mid, dims=axis)
