"""Linear convolution for the channel simulator (port of ofdm_tpu/ops/convolve.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fft import fft, ifft, require_full_fp32


def convolve_direct(x: torch.Tensor, h_real: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of complex ``x`` (batched, last axis) with a
    real kernel ``h``; output length T + K - 1, as the reference's.

    ``conv1d`` computes a correlation, so the kernel is reversed.  On CUDA it
    runs through cuDNN, which must not use TF32 (``require_full_fp32``).
    """
    require_full_fp32(x.device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    k = h_real.shape[-1]
    lead, t = x.shape[:-1], x.shape[-1]
    planes = torch.stack([x.real, x.imag]).reshape(-1, 1, t)
    w = h_real.to(planes.dtype).flip(-1).reshape(1, 1, k)
    out = F.conv1d(planes, w, padding=k - 1).reshape(2, *lead, t + k - 1)
    out = torch.complex(out[0], out[1])
    return out[0] if squeeze else out


def convolve_fft(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """FFT-based linear convolution of two 1-D signals, parity with
    src/signals/mod.rs:219-237; output length T + K - 1."""
    n = x.shape[-1] + h.shape[-1] - 1
    xp = torch.cat([x, x.new_zeros(n - x.shape[-1])])
    hp = h.to(xp.dtype)
    hp = torch.cat([hp, hp.new_zeros(n - h.shape[-1])])
    return ifft(fft(xp, use_matmul=False) * fft(hp, use_matmul=False),
                use_matmul=False)
