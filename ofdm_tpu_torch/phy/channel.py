"""Simulated multipath channel (port of ofdm_tpu/phy/channel.py).

Behaviour of the reference's channel (src/channel.rs:32-74), batched:

- convolve with the fixed 64-tap impulse response (linear, output T + 63);
- optional carrier-frequency offset f_delta = pi * U(0,1) / 80, applied as
  y[n] *= exp(+j f_delta (n+1));
- additive noise with noise_var = complex pseudo-variance(signal) / snr_lin
  and noise = sqrt(0.5 * noise_var) * (U(-1,1) + j U(-1,1)).

Both reference quirks are kept: the noise amplitude comes from the complex
(unconjugated) square variance, and the noise is uniform, not Gaussian.
Randomness comes from an explicit ``torch.Generator``; it cannot reproduce
the JAX package's ``jax.random`` bits, so tests compare distributions or
feed both packages the same received samples.
"""

from __future__ import annotations

import math

import torch

from .. import constants
from ..ops.convolve import convolve_direct
from ..ops.fft import real_dtype


def _complex_pseudo_variance(y: torch.Tensor) -> torch.Tensor:
    """sum((mean - y)^2) / N with the complex square (SignalRef::variance,
    src/signals/mod.rs:239-249)."""
    diff = y.mean(-1, keepdim=True) - y
    return (diff * diff).mean(-1)


def channel(transmission: torch.Tensor, snr: float = 30.0,
            timing_error: bool = False,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply the simulated channel on the transmission's device; batched over
    leading axes.  ``generator`` must live on that device; None seeds a
    fresh one with 0."""
    squeeze = transmission.dim() == 1
    if squeeze:
        transmission = transmission[None, :]
    dev = transmission.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    batch = transmission.shape[:-1]
    rd = real_dtype(transmission.dtype)

    taps = torch.as_tensor(constants.CHANNEL_TAPS, dtype=rd, device=dev)
    out = convolve_direct(transmission, taps)
    n_out = out.shape[-1]
    if timing_error:
        u = torch.rand(batch, generator=generator, dtype=rd, device=dev)
        f_delta = math.pi * u / 80.0
        n = torch.arange(1, n_out + 1, dtype=rd, device=dev)
        angle = f_delta[..., None] * n
        out = out * torch.polar(torch.ones_like(angle), angle)

    noise_var = _complex_pseudo_variance(out) / 10.0 ** (snr / 10.0)
    amp = torch.sqrt(0.5 * noise_var)          # complex sqrt, principal branch
    uni = torch.rand((*batch, n_out, 2), generator=generator, dtype=rd,
                     device=dev) * 2.0 - 1.0
    out = out + amp[..., None] * torch.complex(uni[..., 0], uni[..., 1])
    return out[0] if squeeze else out
