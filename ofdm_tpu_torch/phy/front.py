"""The matrix-derot front half, once for every decoder: ``estimates`` (CFO,
channel) and ``derot_spectrum`` (the derotated DFT at the selected bins) on
views of each decoder's own chunk layout; no host sync, CUDA-graph safe."""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..config import FrameConfig
from ..kernels.derot import dft_matmul_select_derot_planar
from ..ops.fft import device_table, dft_matmul

DEROT_IMPLS = ("auto", "matrix", "stream")


def resolve_derot(derot_impl: str) -> str:
    if derot_impl not in DEROT_IMPLS:
        raise ValueError(f"unknown derot_impl {derot_impl!r}; expected one "
                         f"of {DEROT_IMPLS}")
    return "matrix" if derot_impl == "auto" else derot_impl


def estimate_chunks(cfg: FrameConfig):
    """(left, right, training): the chunks the estimates read."""
    t0 = cfg.n_locking + cfg.n_preamble
    return t0 - 2, t0 - 1, slice(t0, t0 + cfg.n_training)


def cfo_estimate(left: torch.Tensor, right: torch.Tensor, cfg: FrameConfig,
                 estimator: str) -> torch.Tensor:
    """f_delta from two consecutive preamble chunks [..., sym_len].

    "reference": |mean of the per-sample angles of right/left| / sym_len, the
    reference's estimator (src/receiver.rs:231-240), which loses frames when
    noise wraps single angles past +-pi.  "coherent": |angle of
    sum(right * conj(left))| / sym_len, the same statistic on clean signals
    but immune to those wraps.
    """
    if estimator == "coherent":
        corr = (right * left.conj()).sum(-1)
        return (torch.angle(corr) / cfg.sym_len).abs()
    if estimator == "reference":
        return (torch.angle(right / left).mean(-1) / cfg.sym_len).abs()
    raise ValueError(f"unknown cfo_estimator {estimator!r}")


def phasor(angles: torch.Tensor) -> torch.Tensor:
    """exp(-j * angles)."""
    return torch.polar(torch.ones_like(angles), -angles)


def selected_bins(guard_bands: bool, cfg: FrameConfig):
    """(bins, n_data, n_pilots): the DFT bins the tail reads, data first."""
    if guard_bands:
        nd = len(cfg.data_indices)
        return (tuple(int(i) for i in cfg.data_indices)
                + tuple(cfg.pilot_indices), nd, len(cfg.pilot_indices))
    return tuple(range(cfg.n_fft)), cfg.n_fft, 0


def channel_estimate(tr_raw: torch.Tensor, f_delta: torch.Tensor,
                     cfg: FrameConfig) -> torch.Tensor:
    """h_k [R, n_fft] from the raw training chunks [R, n_training, n_fft]
    (CP stripped), derotated here (a small tensor)."""
    t0 = estimate_chunks(cfg)[2].start
    rd, dev = f_delta.dtype, f_delta.device
    tr_idx = ((torch.arange(cfg.n_training, dtype=rd, device=dev) + t0)
              * cfg.sym_len)[:, None] \
        + (torch.arange(cfg.n_fft, dtype=rd, device=dev) + cfg.cp_len)[None, :]
    tr = tr_raw * phasor(f_delta[:, None, None] * tr_idx)
    training_ref = device_table(constants.training_signals,
                                (cfg.n_fft, cfg.training_seed), tr.dtype, dev)
    return (dft_matmul(tr) / training_ref).mean(-2)


def h_selected(h_k: torch.Tensor, guard_bands: bool, cfg: FrameConfig):
    """(h_k at the selected bins, n_data, n_pilots)."""
    sel, nd, n_pilots = selected_bins(guard_bands, cfg)
    return (h_k[:, device_table(np.asarray, (sel,), torch.long, h_k.device)],
            nd, n_pilots)


def estimates(left, right, training, *, cfg: FrameConfig, cfo_estimator: str):
    """(f_delta [R], h_k [R, n_fft]) from ``estimate_chunks``' complex
    chunks: left, right [R, sym_len], training [R, n_training, n_fft]."""
    f_delta = cfo_estimate(left, right, cfg, cfo_estimator)
    return f_delta, channel_estimate(training, f_delta, cfg)


def derot_spectrum(xr, xi, f_delta, *, guard_bands: bool, cfg: FrameConfig):
    """(yr, yi) [R, C, nbins]: the selected bins of chunk planes [R, C, >=
    sym_len] past the CP, derotated within each symbol by f_delta."""
    return dft_matmul_select_derot_planar(
        xr[..., cfg.cp_len:cfg.sym_len], xi[..., cfg.cp_len:cfg.sym_len],
        selected_bins(guard_bands, cfg)[0], f_delta, sample_offset=cfg.cp_len)
