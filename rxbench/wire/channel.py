"""The simulated channel of src/channel.rs:32-74, batched, with a signal to
noise ratio of its own for every segment.

- convolve with the fixed 64-tap response (output T + 63);
- with a timing error: multiply sample n (from 1) by exp(+j f n), f = pi U(0,1) / 80;
- add uniform noise sqrt(0.5 v) (U(-1,1) + j U(-1,1)) with v the complex
  (unconjugated) variance of the segment divided by its linear SNR: the
  reference's two quirks, kept.

A row is one segment, or ``segment`` samples cut it into several (frames
back to back in one stream; the last takes the rest of the row), each with
its own entry of ``snr_db``.  Randomness comes from a ``torch.Generator``
on the row's device.
"""

from __future__ import annotations

import math

import torch

from . import frame


def channel(tx: torch.Tensor, snr_db: torch.Tensor, *,
            timing_error: torch.Tensor, generator: torch.Generator,
            segment: int | None = None) -> torch.Tensor:
    """tx complex [B, T] -> complex64 [B, T + 63].

    ``snr_db``: float [B] or, with ``segment``, [B, n_segments].
    ``timing_error``: bool [B]."""
    x = tx.to(torch.complex128)
    b, t = x.shape
    dev = x.device
    taps = frame.CHANNEL_TAPS
    out = x.new_zeros((b, t + len(taps) - 1))
    for k in range(len(taps)):
        if taps[k]:
            out[:, k:k + t] += taps[k] * x
    n_out = out.shape[-1]
    f = math.pi * torch.rand(b, generator=generator, dtype=torch.float64,
                             device=dev) / 80.0
    f = torch.where(timing_error.to(dev), f, torch.zeros_like(f))
    n = torch.arange(1, n_out + 1, dtype=torch.float64, device=dev)
    out = out * torch.polar(torch.ones(()).to(dev, torch.float64),
                            f[:, None] * n)
    snr = snr_db.to(dev, torch.float64).reshape(b, -1)
    n_seg = snr.shape[1]
    seg = n_out if segment is None else segment
    # segment bounds; the last segment takes the rest of the row
    bounds = [i * seg for i in range(n_seg)] + [n_out]
    lo = torch.tensor(bounds[:-1], device=dev)
    hi = torch.tensor(bounds[1:], device=dev)
    counts = (hi - lo).to(torch.float64)
    per_sample = torch.repeat_interleave(torch.arange(n_seg, device=dev),
                                         hi - lo, output_size=n_out)

    def segment_sums(v):
        cs = torch.cat([v.new_zeros((b, 1)), torch.cumsum(v, -1)], dim=-1)
        return cs[:, hi] - cs[:, lo]

    mean = segment_sums(out) / counts
    diff = mean[:, per_sample] - out
    var = segment_sums(diff * diff) / counts
    amp = torch.sqrt(0.5 * var / 10.0 ** (snr / 10.0))
    uni = torch.rand((b, n_out, 2), generator=generator, dtype=torch.float64,
                     device=dev) * 2.0 - 1.0
    noise = amp[:, per_sample] * torch.complex(uni[..., 0], uni[..., 1])
    return (out + noise).to(torch.complex64)
