"""Receive chain: sample stream -> bytes (port of ofdm_tpu/phy/rx.py).

The batched path, ``decode_frame``, runs three stages on the input's device:

  1. sync + align: the ``sync_align`` kernel correlates every row with the
     locking template, takes the reference's argmax - 1 offset
     (src/receiver.rs:20-25) and writes the aligned window as f32 planes;
  2. the CFO estimate from the last two preamble chunks, the channel
     estimate from the training chunks, and the data DFT at the used bins
     with the within-symbol CFO phasor folded into a per-row DFT matrix
     ("matrix derot", a dense fp32 ``torch.bmm``);
  3. the tail: the ``eq_demod_pack`` kernel applies the per-chunk CFO phase,
     equalizes, removes the pilot phase, demodulates and packs the bytes.

On a CPU tensor both kernels run their plain PyTorch versions.  Matrix
derot is the only derotation here (the JAX package also has a stream
derotation, and TPU lowering selectors that are not ported).

``decode`` is the reference-parity entry for one stream: host-driven
length, the reference CFO estimator, header parsing and truncation.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..kernels.align import sync_align
from ..kernels.demod import eq_demod_pack
from ..ops.fft import (device_table, dft_matmul, dft_matmul_select_derot_planar,
                       require_full_fp32)
from ..ops.xcorr import locking_sync_offset
from ..packets.header import HEADER_LEN, Header
from .modulation import Modulation, _pad_last


class DecodeError(ValueError):
    """Raised when the stream cannot be decoded (reference: anyhow errors)."""


def sync_offset(samples: torch.Tensor,
                cfg: FrameConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Reference frame-sync offset, argmax - 1 (complex [B, T] or [T])."""
    dtype = np.complex64 if samples.dtype == torch.complex64 else np.complex128
    return locking_sync_offset(samples, constants.locking_for(cfg).astype(dtype))


def _cfo_estimate_lr(left: torch.Tensor, right: torch.Tensor,
                     cfg: FrameConfig, estimator: str) -> torch.Tensor:
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


def _phasor(angles: torch.Tensor) -> torch.Tensor:
    """exp(-j * angles)."""
    return torch.polar(torch.ones_like(angles), -angles)


def _selected_bins(guard_bands: bool, cfg: FrameConfig):
    """(bins, n_data, n_pilots): the DFT bins the tail reads, data first."""
    if guard_bands:
        nd = len(cfg.data_indices)
        return (tuple(int(i) for i in cfg.data_indices)
                + tuple(cfg.pilot_indices), nd, len(cfg.pilot_indices))
    return tuple(range(cfg.n_fft)), cfg.n_fft, 0


def _tail_inputs(cp_re: torch.Tensor, cp_im: torch.Tensor, *,
                 guard_bands: bool, cfg: FrameConfig, cfo_estimator: str):
    """Matrix-derot front half on aligned planes [R, n_chunks, sym_len].

    Returns (yr, yi, h_sel, f_delta): the DFT planes [R, NB, nbins] at the
    selected bins (CFO-derotated within each symbol), the channel estimate
    at those bins, and the CFO estimate; exactly what ``eq_demod_pack`` takes.
    """
    sym = cfg.sym_len
    rd = cp_re.dtype
    last = cfg.n_locking + cfg.n_preamble - 1
    f_delta = _cfo_estimate_lr(
        torch.complex(cp_re[:, last - 1], cp_im[:, last - 1]),
        torch.complex(cp_re[:, last], cp_im[:, last]), cfg, cfo_estimator)

    # channel estimate: derotate just the training chunks (a small tensor)
    t0 = cfg.n_locking + cfg.n_preamble
    tr_raw = torch.complex(cp_re[:, t0:t0 + cfg.n_training, cfg.cp_len:],
                           cp_im[:, t0:t0 + cfg.n_training, cfg.cp_len:])
    dev = cp_re.device
    tr_idx = ((torch.arange(cfg.n_training, dtype=rd, device=dev) + t0)
              * sym)[:, None] \
        + (torch.arange(cfg.n_fft, dtype=rd, device=dev) + cfg.cp_len)[None, :]
    tr = tr_raw * _phasor(f_delta[:, None, None] * tr_idx)
    training_ref = device_table(constants.training_signals,
                                (cfg.n_fft, cfg.training_seed), tr.dtype,
                                tr.device)
    h_k = (dft_matmul(tr) / training_ref).mean(-2)

    sel, _, _ = _selected_bins(guard_bands, cfg)
    yr, yi = dft_matmul_select_derot_planar(
        cp_re[:, cfg.n_sync_chunks:, cfg.cp_len:],
        cp_im[:, cfg.n_sync_chunks:, cfg.cp_len:],
        sel, f_delta, sample_offset=cfg.cp_len)
    h_sel = h_k[:, device_table(np.asarray, (sel,), torch.long, dev)]
    return yr, yi, h_sel, f_delta.contiguous()


def _decode_planes(planes: torch.Tensor, *, n_chunks: int, guard_bands: bool,
                   modulation: Modulation, cfg: FrameConfig,
                   cfo_estimator: str) -> torch.Tensor:
    """Decode aligned f32 planes [R, 2, n_chunks * sym_len] -> uint8 [R, n]."""
    cp = planes.reshape(planes.shape[0], 2, n_chunks, cfg.sym_len)
    yr, yi, h_sel, f_delta = _tail_inputs(
        cp[:, 0], cp[:, 1], guard_bands=guard_bands, cfg=cfg,
        cfo_estimator=cfo_estimator)
    _, nd, n_pilots = _selected_bins(guard_bands, cfg)
    return eq_demod_pack(yr, yi, h_sel, f_delta, n_data=nd, n_pilots=n_pilots,
                         modulation=modulation, cfg=cfg)


def _decode_batch(flat: torch.Tensor, n_blocks: int, guard_bands: bool,
                  modulation: Modulation, cfg: FrameConfig,
                  search_window: int | None, cfo_estimator: str):
    """sync_align + decode of complex64 [R, T] or f32 [R, 2, T] rows."""
    require_full_fp32(flat.device)
    n_chunks = cfg.n_sync_chunks + n_blocks
    need = n_chunks * cfg.sym_len
    flat = _pad_last(flat, need - flat.shape[-1]).contiguous()
    planes, _ = sync_align(flat, constants.locking_for(cfg), need,
                           search_window=search_window, planar=True)
    return _decode_planes(planes, n_chunks=n_chunks, guard_bands=guard_bands,
                          modulation=modulation, cfg=cfg,
                          cfo_estimator=cfo_estimator)


def decode_frame(samples: torch.Tensor, *, n_blocks: int,
                 guard_bands: bool = False,
                 modulation: Modulation = Modulation.BPSK,
                 cfg: FrameConfig = DEFAULT_CONFIG,
                 search_window: int | None = None,
                 cfo_estimator: str = "coherent") -> torch.Tensor:
    """Batched decode with static shapes: complex[..., T] -> uint8[..., n_bytes].

    ``n_blocks`` is the number of data OFDM symbols (known from the
    deployment).  Each row's sync offset stays on the device.  Rows shorter
    than the frame are zero-padded.  ``search_window`` bounds the sync scan
    to lags below ``search_window + sym_len`` (reacquisition near a known
    frame start); None scans the whole row, as the reference.
    ``cfo_estimator`` defaults to "coherent" (see ``_cfo_estimate_lr``).
    complex128 input is decoded in complex64.  On CUDA, TF32 must be off
    (``ops.fft.require_full_fp32``).
    """
    squeeze = samples.dim() == 1
    if squeeze:
        samples = samples[None, :]
    lead = samples.shape[:-1]
    flat = samples.to(torch.complex64).reshape(-1, samples.shape[-1])
    out = _decode_batch(flat, n_blocks, guard_bands, modulation, cfg,
                        search_window, cfo_estimator)
    out = out.reshape(*lead, out.shape[-1])
    return out[0] if squeeze else out


def decode_frame_planar(planes: torch.Tensor, *, n_blocks: int,
                        guard_bands: bool = False,
                        modulation: Modulation = Modulation.BPSK,
                        cfg: FrameConfig = DEFAULT_CONFIG,
                        search_window: int | None = None,
                        cfo_estimator: str = "coherent") -> torch.Tensor:
    """``decode_frame`` for a planar stream: f32 [..., 2, T] real/imag planes
    (as captures deinterleave to).  The planes feed ``sync_align`` directly,
    so no complex64 copy of the stream is made."""
    if planes.dim() < 2 or planes.shape[-2] != 2:
        raise ValueError(f"planes must be [..., 2, T], got {tuple(planes.shape)}")
    squeeze = planes.dim() == 2
    if squeeze:
        planes = planes[None]
    lead = planes.shape[:-2]
    flat = planes.to(torch.float32).reshape(-1, 2, planes.shape[-1])
    out = _decode_batch(flat, n_blocks, guard_bands, modulation, cfg,
                        search_window, cfo_estimator)
    out = out.reshape(*lead, out.shape[-1])
    return out[0] if squeeze else out


def decode(samples, guard_bands: bool = False,
           modulation: Modulation = Modulation.BPSK,
           cfg: FrameConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Reference-parity decode of one 1-D stream (src/receiver.rs:8-96):
    returns the payload bytes as a numpy uint8 array.

    The stream is decoded from its sync offset to its end, the tail chunk
    zero-padded (split_into_chunks, src/receiver.rs:192-210), with the
    reference CFO estimator; the header's length truncates the payload.
    Raises DecodeError where the reference bails out on short input.
    ``samples``: a 1-D complex tensor (its device is used) or array.
    """
    x = samples if isinstance(samples, torch.Tensor) \
        else torch.as_tensor(np.asarray(samples))
    if x.dim() != 1:
        raise ValueError("decode takes one 1-D stream")
    x = x.to(torch.complex64)
    require_full_fp32(x.device)
    sym = cfg.sym_len
    t = x.shape[-1]
    if t < cfg.n_sync_chunks * sym:
        raise DecodeError("Input not long enough, bailing early")
    # One sync_align call over lags [0, T) of the stream, zero-padded so the
    # window at any offset holds the longest frame the stream can carry.
    template = constants.locking_for(cfg)
    need_max = -(-t // sym) * sym
    window, raw = sync_align(_pad_last(x, need_max)[None], template, need_max,
                             search_window=t - len(template), planar=True)
    offset = int(raw[0])
    # The reference computes peak_lag - 1 and panics on -1 (a clean stream
    # with no delay); clamp it to 0: the same alignment.
    if offset == -1:
        offset = 0
    if offset < 0 or offset > t:
        raise DecodeError(f"sync offset {offset} out of range")
    remaining = t - offset
    if remaining < cfg.n_sync_chunks * sym:
        raise DecodeError("Input not long enough, bailing early")
    n_chunks = -(-remaining // sym)
    planes = window[:, :, :n_chunks * sym].contiguous()
    out = _decode_planes(planes, n_chunks=n_chunks, guard_bands=guard_bands,
                         modulation=modulation, cfg=cfg,
                         cfo_estimator="reference")
    raw_bytes = out[0].cpu().numpy()
    if raw_bytes.shape[-1] < HEADER_LEN:
        raise DecodeError("decoded stream shorter than header")
    header = Header.from_bytes(raw_bytes[:HEADER_LEN].tobytes())
    # Vec::truncate caps at the available length
    n = min(header.packet_length, raw_bytes.shape[-1] - HEADER_LEN)
    return raw_bytes[HEADER_LEN:HEADER_LEN + n]
