"""Signal statistics with the reference's semantics (port of
ofdm_tpu/ops/stats.py; SignalRef trait, src/signals/mod.rs:239-281)."""

from __future__ import annotations

import torch


def mean(signal: torch.Tensor) -> torch.Tensor:
    """Complex mean over the last axis (src/signals/mod.rs:251-259)."""
    return signal.mean(dim=-1)


def variance(signal: torch.Tensor) -> torch.Tensor:
    """Complex pseudo-variance: sum((mean - x)^2)/N with the *unconjugated*
    square, the reference's deliberate deviation from MATLAB's E|x-mean|^2
    (src/signals/mod.rs:239-249).  Drives the channel's noise amplitude."""
    diff = mean(signal)[..., None] - signal
    return (diff * diff).mean(dim=-1)


def idmax(signal: torch.Tensor) -> torch.Tensor:
    """Index of the max-|.|^2 element, first occurrence on ties: the
    intended argmax of the reference's idmax (src/signals/mod.rs:271-281
    never updates its running max).  The first occurrence is taken
    explicitly: ``torch.argmax`` does not promise one on ties."""
    power = signal.real ** 2 + signal.imag ** 2
    n = power.shape[-1]
    idx = torch.arange(n, device=power.device)
    is_max = power == power.amax(dim=-1, keepdim=True)
    return torch.where(is_max, idx, n).amin(dim=-1)
