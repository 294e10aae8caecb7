"""Carry the JAX package's state across to the port.

The system has no learned weights: its state is the frame geometry and the
seeded constant tables.  These helpers take ``ofdm_tpu`` objects by duck
typing (nothing here imports ``ofdm_tpu``) and expose every table the port
computes with, so tests can hold them bitwise against the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants
from .config import DEFAULT_CONFIG, FrameConfig
from .ops.fft import _dft_matrix, _dft_select_planes
from .ops.xcorr import _toeplitz_template, _toeplitz_template_real, template_key
from .phy.front import selected_bins
from .phy.modulation import Modulation


def frame_config_from_reference(cfg) -> FrameConfig:
    """The port's FrameConfig equal to a JAX ``ofdm_tpu.FrameConfig``."""
    return FrameConfig(**dataclasses.asdict(cfg))


def modulation_from_reference(m) -> Modulation:
    """The port's Modulation with the same ``.value`` as a JAX one."""
    return Modulation(m.value)


def tables(cfg: FrameConfig = DEFAULT_CONFIG) -> dict[str, np.ndarray]:
    """Every constant table the port uses for ``cfg``, as numpy arrays."""
    locking = constants.locking_for(cfg)
    key = template_key(locking.astype(np.complex64))
    out = {
        "locking": locking,
        "preamble": constants.preamble(cfg.sym_len, cfg.preamble_seed),
        "training": constants.training_signals(cfg.n_fft, cfg.training_seed),
        "channel_taps": constants.CHANNEL_TAPS,
        "toeplitz_real": _toeplitz_template_real(key, "float32"),
        "toeplitz_complex": _toeplitz_template(key, "float32"),
        "dft": _dft_matrix(cfg.n_fft, False),
        "idft": _dft_matrix(cfg.n_fft, True),
    }
    for gb in (False, True):
        sel, _, _ = selected_bins(gb, cfg)
        wr, wi = _dft_select_planes(cfg.n_fft, sel, "float32")
        out[f"dft_select_re_gb{int(gb)}"] = wr
        out[f"dft_select_im_gb{int(gb)}"] = wi
    return out
