"""Deterministic frame constants, regenerated at import time.

These replicate the reference's seeded reference signals and simulated channel
taps (all cited to the reference Rust crate):

- ``locking_signal``: 80-sample fft-shifted real ramp (src/transmitter.rs:60-72)
- ``preamble``: 80 pseudorandom samples, StdRng seed 100, x0.25
  (src/transmitter.rs:75-84)
- ``training``: 64 pseudorandom samples, StdRng seed 50 (src/transmitter.rs:88-96).
  Note the reference receiver asks for an 80-long training signal
  (src/receiver.rs:216) but only ever consumes the first 64 values, which are
  identical to the 64-long sequence because generation is sequential from the
  same seed — we standardize on the 64-length table on both sides and lock that
  equivalence with a test.
- ``CHANNEL_TAPS``: fixed 64-tap multipath impulse response (src/channel.rs:26-31)

A copy (same code) of ``ofdm_tpu/constants.py``: any import under ``ofdm_tpu``
runs that package's ``__init__``, which imports jax, and this package
must run where jax is absent.  tests/test_torch_constants.py holds the
two copies equal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .core.rustrng import complex_uniform_sequence


def _fft_shift(x: np.ndarray) -> np.ndarray:
    """Reference fft_shift (src/signals/mod.rs:61-77) == np.fft.fftshift."""
    mid = int(np.floor((len(x) + 1) / 2))
    return np.concatenate([x[mid:], x[:mid]])


@lru_cache(maxsize=None)
def locking_signal(length: int = 80) -> np.ndarray:
    idx = np.arange(length, dtype=np.float64)
    v = 0.5 * (idx / (2.0 * length) + 0.5)
    return _fft_shift(v.astype(np.complex128))


@lru_cache(maxsize=None)
def preamble(length: int = 80, seed: int = 100) -> np.ndarray:
    return complex_uniform_sequence(seed, length, scale=0.25)


@lru_cache(maxsize=None)
def training_signals(length: int = 64, seed: int = 50) -> np.ndarray:
    return complex_uniform_sequence(seed, length, scale=1.0)


def locking_for(cfg) -> np.ndarray:
    """The locking block for a FrameConfig: the reference ramp by default, or
    a seeded pseudorandom sequence (sharp autocorrelation) when
    cfg.locking_seed is set."""
    if cfg.locking_seed is None:
        return locking_signal(cfg.sym_len)
    return complex_uniform_sequence(cfg.locking_seed, cfg.sym_len, scale=0.5)


# Fixed multipath impulse response, verbatim values from src/channel.rs:26-31
# (the "original channel expanded onto a 64 wide block").
CHANNEL_TAPS = np.zeros(64, dtype=np.float64)
CHANNEL_TAPS[7:19] = [
    -0.0000, -0.1912, 0.9316, 0.2821, -0.1990, 0.1630,
    -0.1017, 0.0544, -0.0261, 0.0090, 0.0000, -0.0034,
]
