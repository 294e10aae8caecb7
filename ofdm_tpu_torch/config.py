"""Frame geometry and runtime configuration.

The reference hard-codes its frame geometry as const-generics scattered through
``src/transmitter.rs:22-34`` (1 locking block, 4 preambles, 5 training blocks,
64-pt FFT, 16-sample CP) and its guard/pilot layout inline in ``encode_block``
(``src/transmitter.rs:151-160``).  Here the geometry is one frozen dataclass so
apps, tests and the sharded pipeline all agree on a single source of truth.

A copy (same code) of ``ofdm_tpu/config.py``: any import under ``ofdm_tpu``
runs that package's ``__init__``, which imports jax, and this package
must run where jax is absent.  tests/test_torch_constants.py holds the
two copies equal.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """OFDM frame geometry (defaults = reference wire format)."""

    n_fft: int = 64          # subcarriers per OFDM symbol (src/transmitter.rs:147)
    cp_len: int = 16         # cyclic prefix samples (src/transmitter.rs:52)
    n_locking: int = 1       # locking blocks (src/transmitter.rs:22)
    n_preamble: int = 4      # preamble repeats (src/transmitter.rs:27)
    n_training: int = 5      # training blocks (src/transmitter.rs:32)
    preamble_seed: int = 100  # src/transmitter.rs:76
    training_seed: int = 50   # src/transmitter.rs:89
    header_len_bytes: int = 16  # bincode u128 (src/packets/mod.rs:25)

    # None -> the reference's fft-shifted ramp locking block
    # (src/transmitter.rs:60-72).  The ramp's autocorrelation is nearly flat
    # (DC-dominated), which barely localizes at sym_len > 80; setting a seed
    # switches to a pseudorandom locking sequence with a sharp correlation
    # peak — recommended for custom geometries.
    locking_seed: int | None = None

    # Guard band / pilot layout, matching src/transmitter.rs:151-160:
    # guards: i >= 59 || i <= 5 || i == 32 ; pilots: {6, 25, 39, 58} at 1+0j
    pilot_indices: tuple[int, ...] = (6, 25, 39, 58)
    pilot_value: complex = 1.0 + 0.0j

    @property
    def sym_len(self) -> int:
        """Samples per prefixed OFDM symbol (80 for the reference)."""
        return self.n_fft + self.cp_len

    @property
    def sync_len(self) -> int:
        """Samples of locking+preamble+training overhead before data blocks."""
        return (self.n_locking + self.n_preamble + self.n_training) * self.sym_len

    @property
    def n_sync_chunks(self) -> int:
        return self.n_locking + self.n_preamble + self.n_training

    @cached_property
    def guard_mask(self) -> np.ndarray:
        """Bool[n_fft]: True where the bin is a guard band / DC null."""
        i = np.arange(self.n_fft)
        return (i >= 59) | (i <= 5) | (i == 32)

    @cached_property
    def pilot_mask(self) -> np.ndarray:
        """Bool[n_fft]: True where the bin carries a pilot tone."""
        mask = np.zeros(self.n_fft, dtype=bool)
        mask[list(self.pilot_indices)] = True
        return mask

    @cached_property
    def data_mask(self) -> np.ndarray:
        """Bool[n_fft]: True where the bin carries payload symbols (guardbands on)."""
        return ~(self.guard_mask | self.pilot_mask)

    @cached_property
    def data_indices(self) -> np.ndarray:
        """Data-carrier bin indices in transmit order (guardbands on)."""
        return np.nonzero(self.data_mask)[0]

    def carriers_per_block(self, guard_bands: bool) -> int:
        return int(self.data_mask.sum()) if guard_bands else self.n_fft


DEFAULT_CONFIG = FrameConfig()
