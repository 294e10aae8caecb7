"""The wire format's geometry and constants, frozen for the benchmark.

jkelleyrtp/ofdm's frame (src/transmitter.rs:11-58): a locking block, four
preambles, five prefixed training blocks, then the data blocks, each 64
bins through an IFFT with a 16-sample cyclic prefix, the whole frame
divided by its largest real or imaginary component.  With guard bands
(src/transmitter.rs:151-160) bins 0-5, 32 and 59-63 are empty, bins 6, 25,
39 and 58 carry the pilot 1+0j, and the 48 others carry data.  The payload
is led by a 16-byte little-endian length header (src/packets/mod.rs:20-32).
The simulated channel convolves with a fixed 64-tap response
(src/channel.rs:26-31).

The traffic generator and the reference receiver both read this module;
neither reads the program's tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .rustrng import complex_uniform_sequence

N_FFT = 64
CP_LEN = 16
SYM_LEN = N_FFT + CP_LEN
N_LOCKING = 1
N_PREAMBLE = 4
N_TRAINING = 5
N_SYNC_CHUNKS = N_LOCKING + N_PREAMBLE + N_TRAINING
SYNC_LEN = N_SYNC_CHUNKS * SYM_LEN
HEADER_LEN = 16
PILOT_BINS = (6, 25, 39, 58)
BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6,
                   "qam256": 8}

CHANNEL_TAPS = np.zeros(64)
CHANNEL_TAPS[7:19] = [-0.0000, -0.1912, 0.9316, 0.2821, -0.1990, 0.1630,
                      -0.1017, 0.0544, -0.0261, 0.0090, 0.0000, -0.0034]


def data_bins(guard_bands: bool) -> np.ndarray:
    """The bins that carry data, in transmit order."""
    i = np.arange(N_FFT)
    if not guard_bands:
        return i
    used = ~((i >= 59) | (i <= 5) | (i == 32))
    used[list(PILOT_BINS)] = False
    return np.nonzero(used)[0]


def n_data_blocks(payload_len: int, modulation: str, guard_bands: bool) -> int:
    """Data blocks of a frame of ``payload_len`` bytes (header added)."""
    n_syms = -(-(payload_len + HEADER_LEN) * 8 // BITS_PER_SYMBOL[modulation])
    return -(-n_syms // len(data_bins(guard_bands)))


@lru_cache(maxsize=None)
def locking() -> np.ndarray:
    """The fft-shifted real ramp (src/transmitter.rs:60-72)."""
    v = 0.5 * (np.arange(SYM_LEN) / (2.0 * SYM_LEN) + 0.5)
    mid = (SYM_LEN + 1) // 2
    return np.concatenate([v[mid:], v[:mid]]).astype(np.complex128)


@lru_cache(maxsize=None)
def preamble() -> np.ndarray:
    return complex_uniform_sequence(100, SYM_LEN, scale=0.25)


@lru_cache(maxsize=None)
def training() -> np.ndarray:
    """The 64 training bins (src/transmitter.rs:88-96)."""
    return complex_uniform_sequence(50, N_FFT, scale=1.0)


@lru_cache(maxsize=None)
def sync_prefix() -> np.ndarray:
    """Locking, preambles and prefixed training blocks: SYNC_LEN samples."""
    t = np.fft.ifft(training())
    t = np.concatenate([t[-CP_LEN:], t])
    return np.concatenate([locking()] * N_LOCKING + [preamble()] * N_PREAMBLE
                          + [t] * N_TRAINING)


@lru_cache(maxsize=None)
def gray_levels(half: int) -> np.ndarray:
    """Index: an axis's Gray code (bits LSB first); value: its odd level."""
    n = 1 << half
    out = np.zeros(n)
    for rank in range(n):
        out[rank ^ (rank >> 1)] = 2 * rank - (n - 1)
    return out
