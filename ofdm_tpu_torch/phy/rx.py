"""Receive chain: sample stream -> bytes (port of ofdm_tpu/phy/rx.py).

The batched path, ``decode_frame``, runs three stages on the input's device:

  1. sync + align, by one of three routes (``align_impl``):
     - fused (the default): the ``sync_align`` kernel correlates every row
       with the locking template, takes the reference's argmax - 1 offset
       (src/receiver.rs:20-25) and writes the aligned window as f32 planes;
     - unfused: ``sync_offset`` in plain torch (matmul, bf16, overlap-save
       FFT or conv correlation: ``sync_dtype``, and every template over 128
       taps), then the ``planar_align`` kernel copies the windows;
     - chunked: the ``sync_align_chunked`` kernel writes the window as
       slot-major chunk planes, decoded in slot order.
  2. the front half (``front.py``): the CFO and channel estimates from the
     preamble and training chunks, and the data DFT at the used bins.
     "matrix" derot (the default) applies the within-symbol CFO phasor
     inside the DFT (the ``derot_dft`` kernel, full fp32); "stream" derot
     rotates the aligned stream itself, as ``decode`` does.
  3. the tail: the ``eq_demod_pack`` kernel applies the per-chunk CFO phase
     (zero after stream derot), equalizes, removes the pilot phase,
     demodulates and packs the bytes.

A non-contiguous input is made row-major by the ``pin_rowmajor`` kernel
first.  On a card, stages 1 and 2 of a call repeated on the same input are
captured into CUDA graphs by the second such call and replayed by later ones
(``graphs.py``); the tail runs eager into a fresh output.  On a CPU tensor
every kernel runs its plain PyTorch version.  The
JAX package's TPU lowering selectors ``demod_impl`` and ``dft_precision``
are not ported: the tail is always ``eq_demod_pack`` and every DFT is full
fp32 (ofdm_tpu_torch/PARITY.md).

``decode`` is the reference-parity entry for one stream: host-driven
length, the reference CFO estimator, stream derot, header parsing and
truncation.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..core import device as device_mod
from ..kernels.align import pin_rowmajor, planar_align, sync_align
from ..kernels.chain import sync_align_chunked
from ..kernels.demod import eq_demod_pack, equalized_symbols
from ..obs import profiler, taps
from ..ops.fft import (device_table, dft_matmul, dft_matmul_select_planar,
                       require_full_fp32)
from ..ops.xcorr import MAX_TAPS, check_sync_dtype, locking_sync_offset
from ..packets.header import HEADER_LEN, Header
from . import front, graphs
from .modulation import Modulation, _pad_last

ALIGN_IMPLS = ("auto", "fused", "fused_planar", "chunked", "xla", "pallas")


@lru_cache(maxsize=None)
def locking_template(cfg: FrameConfig) -> np.ndarray:
    """``constants.locking_for(cfg)``, built once per geometry (a seeded
    template comes from the pure-Python reference RNG, ~3 ms a build)."""
    return constants.locking_for(cfg)


class DecodeError(ValueError):
    """Raised when the stream cannot be decoded (reference: anyhow errors)."""


def sync_offset(samples: torch.Tensor, cfg: FrameConfig = DEFAULT_CONFIG,
                compute_dtype=None) -> torch.Tensor:
    """Reference frame-sync offset, argmax - 1 (complex [B, T] or [T]).
    ``compute_dtype``: None, torch.bfloat16, "fft" or "conv"
    (``ops.xcorr.locking_sync_offset``)."""
    dtype = np.complex64 if samples.dtype == torch.complex64 else np.complex128
    return locking_sync_offset(samples, locking_template(cfg).astype(dtype),
                               compute_dtype=compute_dtype)


def _matrix_front(cp_re: torch.Tensor, cp_im: torch.Tensor, *,
                  guard_bands: bool, cfg: FrameConfig, cfo_estimator: str):
    """Matrix-derot front half on aligned planes [R, n_chunks, sym_len].

    Returns (yr, yi, h_k, f_delta): the DFT planes [R, NB, nbins] at the
    selected bins (CFO-derotated within each symbol, the per-chunk phase
    left to the tail), the channel estimate and the CFO estimate.
    """
    left, right, train = front.estimate_chunks(cfg)
    f_delta, h_k = front.estimates(
        torch.complex(cp_re[:, left], cp_im[:, left]),
        torch.complex(cp_re[:, right], cp_im[:, right]),
        torch.complex(cp_re[:, train, cfg.cp_len:], cp_im[:, train, cfg.cp_len:]),
        cfg=cfg, cfo_estimator=cfo_estimator)
    yr, yi = front.derot_spectrum(cp_re[:, cfg.n_sync_chunks:],
                                  cp_im[:, cfg.n_sync_chunks:], f_delta,
                                  guard_bands=guard_bands, cfg=cfg)
    return yr, yi, h_k, f_delta


def _stream_front(chunks: torch.Tensor, *, guard_bands: bool,
                  cfg: FrameConfig, cfo_estimator: str):
    """Stream-derot front half on aligned complex chunks [R, n_chunks, sym]
    (ofdm_tpu/phy/rx.py:299-345): the whole stream is rotated by the
    outer-product phasor exp(-j f (sym c + j)), then the channel estimate
    and the DFT at the selected bins read the rotated chunks.

    Returns (yr, yi, h_k, f_delta, rotated chunks)."""
    left, right, train = front.estimate_chunks(cfg)
    f_delta = front.cfo_estimate(chunks[:, left], chunks[:, right], cfg,
                                 cfo_estimator)
    rd, dev = f_delta.dtype, f_delta.device
    rot_c = front.phasor(f_delta[:, None]
                         * (torch.arange(chunks.shape[1], dtype=rd, device=dev)
                            * cfg.sym_len))
    rot_j = front.phasor(f_delta[:, None]
                         * torch.arange(cfg.sym_len, dtype=rd, device=dev))
    rotated = chunks * (rot_c[:, :, None] * rot_j[:, None, :])
    training_ref = device_table(constants.training_signals,
                                (cfg.n_fft, cfg.training_seed), chunks.dtype,
                                dev)
    h_k = (dft_matmul(rotated[:, train, cfg.cp_len:]) / training_ref).mean(-2)
    sel, _, _ = front.selected_bins(guard_bands, cfg)
    yr, yi = dft_matmul_select_planar(
        rotated[:, cfg.n_sync_chunks:, cfg.cp_len:], sel)
    return yr, yi, h_k, f_delta, rotated


def _tail(yr: torch.Tensor, yi: torch.Tensor, h_k: torch.Tensor,
          phase: torch.Tensor, *, guard_bands: bool, modulation: Modulation,
          cfg: FrameConfig, blocks: torch.Tensor | None = None) -> torch.Tensor:
    """``eq_demod_pack`` on the DFT planes, with h_k at the selected bins and
    ``phase`` the per-chunk CFO rate (f_delta, or zeros after stream derot)."""
    with profiler.span("rx.tail", yr):
        h_sel, nd, n_pilots = front.h_selected(h_k, guard_bands, cfg)
        return eq_demod_pack(yr, yi, h_sel, phase.contiguous(), n_data=nd,
                             n_pilots=n_pilots, modulation=modulation, cfg=cfg,
                             blocks=blocks)


def _front(planes: torch.Tensor, *, n_chunks: int, derot: str,
           guard_bands: bool, cfg: FrameConfig, cfo_estimator: str):
    """The front half on aligned f32 planes [R, 2, n_chunks * sym_len]:
    (yr, yi, h_k, phase, f_delta, rotated), ``phase`` the per-chunk CFO
    rate the tail applies (f_delta, or zeros after stream derot) and
    ``rotated`` the derotated chunks (stream derot; None for matrix)."""
    cp = planes.reshape(planes.shape[0], 2, n_chunks, cfg.sym_len)
    kw = dict(guard_bands=guard_bands, cfg=cfg, cfo_estimator=cfo_estimator)
    with profiler.span("rx.front", planes):
        if derot == "matrix":
            yr, yi, h_k, f_delta = _matrix_front(cp[:, 0], cp[:, 1], **kw)
            return yr, yi, h_k, f_delta, f_delta, None
        chunks = torch.complex(cp[:, 0], cp[:, 1])
        yr, yi, h_k, f_delta, rotated = _stream_front(chunks, **kw)
        return yr, yi, h_k, torch.zeros_like(f_delta), f_delta, rotated


def _decode_planes(planes: torch.Tensor, *, n_chunks: int, derot: str,
                   guard_bands: bool, modulation: Modulation, cfg: FrameConfig,
                   cfo_estimator: str, diag: bool = False,
                   equalized: bool = False):
    """Decode aligned f32 planes [R, 2, n_chunks * sym_len] -> (uint8
    [R, n], diag or None).  ``derot``: "matrix" or "stream".  The bytes
    always come from the ``eq_demod_pack`` kernel, which keeps no equalized
    symbols; with ``equalized`` the diag's constellation is computed beside
    it in plain torch from the same planes (``decode``'s diagnostics and
    taps ask for it, no decode path does)."""
    sym = cfg.sym_len
    yr, yi, h_k, phase, f_delta, rotated = _front(
        planes, n_chunks=n_chunks, derot=derot, guard_bands=guard_bands,
        cfg=cfg, cfo_estimator=cfo_estimator)
    out = _tail(yr, yi, h_k, phase, guard_bands=guard_bands,
                modulation=modulation, cfg=cfg)
    if not diag:
        return out, None
    # the reference's debug taps (src/receiver.rs:41,52,58)
    cp = planes.reshape(planes.shape[0], 2, n_chunks, sym)
    pre = torch.complex(cp[:, 0, 6], cp[:, 1, 6])
    if derot == "matrix":
        idx = torch.arange(sym, dtype=f_delta.dtype, device=f_delta.device) \
            + 6 * sym
        post = pre * front.phasor(f_delta[:, None] * idx)
    else:
        post = rotated[:, 6]
    eq = None
    if equalized:
        h_sel, nd, n_pilots = front.h_selected(h_k, guard_bands, cfg)
        eq = equalized_symbols(yr, yi, h_sel, phase, n_data=nd,
                               n_pilots=n_pilots, cfg=cfg)
    return out, {"f_delta": f_delta, "h_k": h_k, "equalized": eq,
                 "chunk6_pre": pre, "chunk6_post": post}


def _unflatten_diag(d: dict, lead: tuple) -> dict:
    return {k: None if v is None else v.reshape((*lead, *v.shape[1:]))
            for k, v in d.items()}


def decode_planar_matrix(planes: torch.Tensor, *, n_chunks: int,
                         guard_bands: bool = False,
                         modulation: Modulation = Modulation.BPSK,
                         cfg: FrameConfig = DEFAULT_CONFIG,
                         cfo_estimator: str = "reference"):
    """Matrix-derot decode of a planar aligned stream: f32 [..., 2, n] with
    n >= n_chunks * sym_len (what ``sync_align(..., planar=True)`` returns),
    batched over leading axes.  Returns (uint8 [..., n_bytes], diag) with
    diag ``f_delta``, ``h_k``, ``chunk6_pre``, ``chunk6_post`` and
    ``equalized`` None (the tail is the ``eq_demod_pack`` kernel)."""
    require_full_fp32(planes.device)
    lead = planes.shape[:-2]
    flat = planes[..., :n_chunks * cfg.sym_len].to(torch.float32).reshape(
        -1, 2, n_chunks * cfg.sym_len)
    out, d = _decode_planes(flat, n_chunks=n_chunks, derot="matrix",
                            guard_bands=guard_bands, modulation=modulation,
                            cfg=cfg, cfo_estimator=cfo_estimator, diag=True)
    return out.reshape(*lead, out.shape[-1]), _unflatten_diag(d, lead)


def decode_aligned(aligned: torch.Tensor, *, n_chunks: int,
                   guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   cfo_estimator: str = "reference",
                   derot_impl: str = "stream"):
    """Decode a sync-aligned complex stream [..., n], n >= n_chunks * sym_len,
    that starts at the locking block.  Returns (uint8 [..., n_bytes], diag):
    diag holds ``f_delta``, ``h_k``, ``chunk6_pre``, ``chunk6_post`` and
    ``equalized`` None (the tail is the ``eq_demod_pack`` kernel, as on the
    JAX package's kernel tail).

    ``derot_impl``: "stream" (default, the reference's derotation of the
    whole stream), "matrix" (the phasor folded into a per-row DFT matrix)
    or "auto" (= "matrix").  complex128 input is decoded in complex64.
    """
    derot = front.resolve_derot(derot_impl)
    require_full_fp32(aligned.device)
    lead = aligned.shape[:-1]
    flat = aligned[..., :n_chunks * cfg.sym_len].to(torch.complex64).reshape(
        -1, n_chunks * cfg.sym_len)
    planes = torch.stack([flat.real, flat.imag], dim=1)
    out, d = _decode_planes(planes, n_chunks=n_chunks, derot=derot,
                            guard_bands=guard_bands, modulation=modulation,
                            cfg=cfg, cfo_estimator=cfo_estimator, diag=True)
    return out.reshape(*lead, out.shape[-1]), _unflatten_diag(d, lead)


def _slot_table(n_cls: int, m_per: int, first: int, n_chunks: int) -> np.ndarray:
    """The slot of each chunk in [first, n_chunks) (chunked layout)."""
    c = np.arange(first, n_chunks)
    return (c % n_cls) * m_per + c // n_cls


def decode_chunked_matrix(chun, *, n_chunks: int, m_per: int,
                          guard_bands: bool = False,
                          modulation: Modulation = Modulation.BPSK,
                          cfg: FrameConfig = DEFAULT_CONFIG,
                          cfo_estimator: str = "coherent") -> torch.Tensor:
    """Matrix-derot decode of slot-major chunk planes.

    ``chun``: (re, im) f32 [..., slots, 128] from
    ``kernels.chain.sync_align_chunked``: chunk c at slot
    (c % n_cls) * m_per + c // n_cls, samples at lanes 0:sym_len.  The
    estimates read the preamble and training slots; the derot DFT runs over
    every slot, reading lanes cp_len:cp_len + n_fft in place; the
    ``eq_demod_pack`` kernel then reads the data slots through a block table
    and writes bytes in chunk order (the JAX package runs this tail in XLA
    and gathers the packed bytes at the end, rx.py:742-828).  Returns uint8
    [..., n_bytes], laid out as ``decode_frame``'s output.
    """
    cr, ci = chun
    require_full_fp32(cr.device)
    lead = cr.shape[:-2]
    cr = cr.reshape(-1, *cr.shape[-2:])
    ci = ci.reshape(-1, *ci.shape[-2:])
    n_cls = cr.shape[1] // m_per
    sym = cfg.sym_len
    left, right, train = front.estimate_chunks(cfg)
    sl, sr = _slot_table(n_cls, m_per, left, right + 1).tolist()
    with profiler.span("rx.front", cr):
        tr = device_table(_slot_table, (n_cls, m_per, train.start, train.stop),
                          torch.long, cr.device)
        f_delta, h_k = front.estimates(
            torch.complex(cr[:, sl, :sym], ci[:, sl, :sym]),
            torch.complex(cr[:, sr, :sym], ci[:, sr, :sym]),
            torch.complex(cr[:, tr, cfg.cp_len:sym], ci[:, tr, cfg.cp_len:sym]),
            cfg=cfg, cfo_estimator=cfo_estimator)
        yr, yi = front.derot_spectrum(cr, ci, f_delta,
                                      guard_bands=guard_bands, cfg=cfg)
    blocks = device_table(_slot_table, (n_cls, m_per, cfg.n_sync_chunks,
                                        n_chunks), torch.int32, cr.device)
    out = _tail(yr, yi, h_k, f_delta, guard_bands=guard_bands,
                modulation=modulation, cfg=cfg, blocks=blocks)
    return out.reshape(*lead, out.shape[-1])


def _resolve_route(align_impl: str, derot_impl: str, sync_dtype,
                   cfg: FrameConfig):
    """(route, derot): route "fused" (K1), "unfused" (sync in torch, then
    K3) or "chunked" (K4); see ``decode_frame``."""
    if align_impl not in ALIGN_IMPLS:
        raise ValueError(f"unknown align_impl {align_impl!r}; expected one "
                         f"of {ALIGN_IMPLS}")
    derot = front.resolve_derot(derot_impl)
    check_sync_dtype(sync_dtype)
    if align_impl == "auto":
        short = len(locking_template(cfg)) <= MAX_TAPS
        route = "fused" if short and sync_dtype is None else "unfused"
    elif align_impl in ("fused", "fused_planar"):
        route = "fused"
    elif align_impl == "chunked":
        route = "chunked"
    else:
        route = "unfused"
    if route != "unfused" and sync_dtype is not None:
        raise ValueError(f"sync_dtype={sync_dtype!r} needs the unfused route "
                         f"(align_impl 'auto', 'xla' or 'pallas'), not "
                         f"{align_impl!r}")
    if route == "chunked" and derot == "stream":
        raise ValueError("align_impl='chunked' decodes with matrix derot only")
    return route, derot


def _sync(flat: torch.Tensor, *, route: str, need: int, cfg: FrameConfig,
          sync_dtype, search_window: int | None):
    """Sync and align complex64 [R, T] or f32 [R, 2, T] rows by ``route``:
    f32 planes [R, 2, need], or on the chunked route K4's (chunk planes,
    m_per)."""
    template = locking_template(cfg)
    with profiler.span("rx.sync", flat):
        if flat.shape[-1] < need:
            flat = _pad_last(flat, need - flat.shape[-1])
        elif not flat.is_contiguous():
            flat = pin_rowmajor(flat)
        t = flat.shape[-1]
        if route == "chunked":
            chun, _, m_per = sync_align_chunked(
                flat, template, n_chunks=need // cfg.sym_len, cfg=cfg,
                search_window=search_window)
            return chun, m_per
        if route == "fused":
            return sync_align(flat, template, need,
                              search_window=search_window, planar=True)[0]
        cplx = flat if flat.dim() == 2 \
            else torch.complex(flat[:, 0], flat[:, 1])
        scan = cplx if search_window is None \
            else cplx[:, :search_window + cfg.sym_len]
        offsets = torch.clamp(
            sync_offset(scan, cfg, compute_dtype=sync_dtype), 0, t - need)
        return planar_align(flat, offsets, need, planar=True)


def _decode_batch(entry, x: torch.Tensor, flatten, *, n_blocks: int,
                  guard_bands: bool, modulation: Modulation, cfg: FrameConfig,
                  sync_dtype, search_window: int | None, cfo_estimator: str,
                  align_impl: str, derot_impl: str) -> torch.Tensor:
    """Decode the rows ``flatten(x)`` (complex64 [R, T] or f32 [R, 2, T]) by
    the chosen route.  On a card, the sync and the front half of the fused
    and unfused routes run through ``graphs.run`` (captured by the second
    call with the same input and selectors, then replayed), the tail eager
    into a fresh output; the call is counted on ``entry``."""
    route, derot = _resolve_route(align_impl, derot_impl, sync_dtype, cfg)
    require_full_fp32(x.device)
    n_chunks = cfg.n_sync_chunks + n_blocks
    kw = dict(guard_bands=guard_bands, modulation=modulation, cfg=cfg,
              cfo_estimator=cfo_estimator)

    def sync(samples):
        return _sync(flatten(samples), route=route,
                     need=n_chunks * cfg.sym_len, cfg=cfg,
                     sync_dtype=sync_dtype, search_window=search_window)

    def front_half(planes):
        return _front(planes, n_chunks=n_chunks, derot=derot,
                      guard_bands=guard_bands, cfg=cfg,
                      cfo_estimator=cfo_estimator)[:4]

    if route == "chunked":
        if x.is_cuda:
            entry.eager_calls += 1
        chun, m_per = sync(x)
        return decode_chunked_matrix(chun, n_chunks=n_chunks, m_per=m_per, **kw)
    if x.is_cuda:
        selectors = (n_blocks, guard_bands, modulation, cfg, sync_dtype,
                     search_window, cfo_estimator, align_impl, derot_impl)
        yr, yi, h_k, phase = graphs.run(
            entry, x, selectors, (("rx.sync", sync), ("rx.front", front_half)))
    else:
        yr, yi, h_k, phase = front_half(sync(x))
    return _tail(yr, yi, h_k, phase, guard_bands=guard_bands,
                 modulation=modulation, cfg=cfg)


def _complex_rows(samples: torch.Tensor) -> torch.Tensor:
    return samples.to(torch.complex64).reshape(-1, samples.shape[-1])


def _planar_rows(planes: torch.Tensor) -> torch.Tensor:
    return planes.to(torch.float32).reshape(-1, 2, planes.shape[-1])


@graphs.entry_point
def decode_frame(samples: torch.Tensor, *, n_blocks: int,
                 guard_bands: bool = False,
                 modulation: Modulation = Modulation.BPSK,
                 cfg: FrameConfig = DEFAULT_CONFIG,
                 sync_dtype=None,
                 search_window: int | None = None,
                 cfo_estimator: str = "coherent",
                 align_impl: str = "auto",
                 derot_impl: str = "auto") -> torch.Tensor:
    """Batched decode with static shapes: complex[..., T] -> uint8[..., n_bytes].

    ``n_blocks`` is the number of data OFDM symbols (known from the
    deployment).  Each row's sync offset stays on the device.  Rows shorter
    than the frame are zero-padded.  ``search_window`` bounds the sync scan
    to lags below ``search_window + sym_len`` (reacquisition near a known
    frame start); None scans the whole row, as the reference.
    ``cfo_estimator`` defaults to "coherent" (see ``front.cfo_estimate``).
    complex128 input is decoded in complex64.  On CUDA, TF32 must be off
    (``ops.fft.require_full_fp32``).

    ``align_impl`` picks how rows are synced and aligned:

    - "auto" (default): the fused ``sync_align`` kernel (K1) when the
      locking template has at most 128 taps and ``sync_dtype`` is None;
      otherwise the unfused route;
    - "fused" and "fused_planar": K1, which always writes f32 planes here;
    - "chunked": the ``sync_align_chunked`` kernel (K4) and the slot-ordered
      tail ``decode_chunked_matrix`` (sym_len and template at most 128);
    - "xla" and "pallas": the unfused route: ``sync_offset`` in plain torch,
      then the ``planar_align`` kernel (K3) copies the windows.

    ``sync_dtype`` (unfused route only): None (f32 matmul correlation, conv
    over 128 taps), torch.bfloat16 (bf16 operands, f32 sums), "fft"
    (overlap-save) or "conv".  ``derot_impl``: "auto" (= "matrix"),
    "matrix" or "stream" (not on the chunked route).  An unknown value, or a
    combination a route cannot take, raises ValueError.  The JAX package's
    ``demod_impl`` and ``dft_precision`` are TPU lowering knobs and are not
    ported: the tail is always ``eq_demod_pack`` and every DFT is full fp32.

    On a card, the fused and unfused routes' sync and front half run as
    CUDA graphs once a call repeats: the same input (address, shape,
    strides, dtype, device), stream and selectors.  The first such call runs
    eager, the second captures, later ones replay (``graphs.py``); the bytes
    are the same, and the returned tensor is always the caller's own.
    ``decode_frame.graph_captures``, ``.graph_replays`` and ``.eager_calls``
    count the CUDA calls each way.
    """
    with profiler.span("rx.decode_frame", samples):
        squeeze = samples.dim() == 1
        if squeeze:
            samples = samples[None, :]
        lead = samples.shape[:-1]
        out = _decode_batch(decode_frame, samples, _complex_rows,
                            n_blocks=n_blocks, guard_bands=guard_bands,
                            modulation=modulation, cfg=cfg,
                            sync_dtype=sync_dtype, search_window=search_window,
                            cfo_estimator=cfo_estimator, align_impl=align_impl,
                            derot_impl=derot_impl)
        out = out.reshape(*lead, out.shape[-1])
        return out[0] if squeeze else out


@graphs.entry_point
def decode_frame_planar(planes: torch.Tensor, *, n_blocks: int,
                        guard_bands: bool = False,
                        modulation: Modulation = Modulation.BPSK,
                        cfg: FrameConfig = DEFAULT_CONFIG,
                        sync_dtype=None,
                        search_window: int | None = None,
                        cfo_estimator: str = "coherent",
                        align_impl: str = "auto",
                        derot_impl: str = "auto") -> torch.Tensor:
    """``decode_frame`` for a planar stream: f32 [..., 2, T] real/imag planes
    (as captures deinterleave to), with the same selectors.  The planes feed
    the kernels directly, so the fused and chunked routes make no complex64
    copy of the stream.  A strided view, such as
    ``torch.view_as_real(rx).transpose(1, 2)``, is made row-major by the
    ``pin_rowmajor`` kernel first; a contiguous input is not copied.  The
    TPU's pre-tiled [..., 2, tiles, 128] form is not taken.  Repeated calls
    run as CUDA graphs as ``decode_frame``'s do, counted in
    ``decode_frame_planar.graph_captures``, ``.graph_replays`` and
    ``.eager_calls``."""
    if planes.dim() < 2 or planes.shape[-2] != 2:
        raise ValueError(f"planes must be [..., 2, T], got {tuple(planes.shape)}")
    with profiler.span("rx.decode_frame", planes):
        squeeze = planes.dim() == 2
        if squeeze:
            planes = planes[None]
        lead = planes.shape[:-2]
        out = _decode_batch(decode_frame_planar, planes, _planar_rows,
                            n_blocks=n_blocks, guard_bands=guard_bands,
                            modulation=modulation, cfg=cfg,
                            sync_dtype=sync_dtype, search_window=search_window,
                            cfo_estimator=cfo_estimator, align_impl=align_impl,
                            derot_impl=derot_impl)
        out = out.reshape(*lead, out.shape[-1])
        return out[0] if squeeze else out


def decode(samples, guard_bands: bool = False,
           modulation: Modulation = Modulation.BPSK,
           cfg: FrameConfig = DEFAULT_CONFIG, device=None,
           return_diagnostics: bool = False):
    """Reference-parity decode of one 1-D stream (src/receiver.rs:8-96):
    returns the payload bytes as a numpy uint8 array.

    The stream is decoded from its sync offset to its end, the tail chunk
    zero-padded (split_into_chunks, src/receiver.rs:192-210), with the
    reference CFO estimator and stream derot (``decode_aligned``'s default,
    as ofdm_tpu's ``decode``); the header's length truncates the payload.
    Templates of at most 128 taps sync and align in one ``sync_align`` call;
    longer ones sync with the conv correlation and align with
    ``planar_align``.  Raises DecodeError where the reference bails out on
    short input.  ``samples``: a 1-D complex tensor or array, decoded on
    ``device``: a tensor's own device when None, else CUDA for an array
    (raises where CUDA is absent; pass ``device="cpu"`` to run on the CPU).

    ``return_diagnostics=True`` returns ``(payload, diag)``: numpy arrays of
    this one stream, ``chunk6_pre`` and ``chunk6_post`` (the 7th chunk
    before and after derotation, complex64 [sym_len]), ``h_k`` (complex64
    [n_fft]), ``equalized`` (the data symbols the tail decided on,
    complex64), ``f_delta`` (0-d float32) and the int ``offset``.  With
    ``obs.taps`` enabled the four signals are also written under the
    reference's tap names (src/receiver.rs:41,52,58,76).  Only then is
    ``equalized`` computed, in plain torch beside the kernel tail; a plain
    call launches nothing more than before.
    """
    x = device_mod.as_tensor(samples, device)
    if x.dim() != 1:
        raise ValueError("decode takes one 1-D stream")
    x = x.to(torch.complex64)
    require_full_fp32(x.device)
    sym = cfg.sym_len
    t = x.shape[-1]
    if t < cfg.n_sync_chunks * sym:
        raise DecodeError("Input not long enough, bailing early")
    template = locking_template(cfg)
    window = None
    if len(template) <= MAX_TAPS:
        # One sync_align call over lags [0, T) of the stream, zero-padded so
        # the window at any offset holds the longest frame it can carry.
        need_max = -(-t // sym) * sym
        window, raw = sync_align(_pad_last(x, need_max)[None], template,
                                 need_max, search_window=t - len(template),
                                 planar=True)
        offset = int(raw[0])
    else:
        offset = int(sync_offset(x, cfg))
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
    if window is not None:
        planes = window[:, :, :n_chunks * sym]
    else:
        # padded by one symbol, the window of the last partial chunk fits
        offsets = torch.tensor([offset], dtype=torch.int32, device=x.device)
        planes = planar_align(_pad_last(x, sym)[None], offsets, n_chunks * sym,
                              planar=True)
    want_diag = return_diagnostics or taps.enabled()
    out, diag = _decode_planes(planes, n_chunks=n_chunks, derot="stream",
                               guard_bands=guard_bands, modulation=modulation,
                               cfg=cfg, cfo_estimator="reference",
                               diag=want_diag, equalized=want_diag)
    if want_diag:
        diag = {k: v[0].cpu().numpy() for k, v in diag.items()}
    if taps.enabled():
        taps.tap("preq_correction_3a", diag["chunk6_pre"])
        taps.tap("post_correction_3a", diag["chunk6_post"])
        taps.tap("hk_estimate_3a", diag["h_k"])
        taps.tap("no_phaseoffset", diag["equalized"])
    raw_bytes = out[0].cpu().numpy()
    if raw_bytes.shape[-1] < HEADER_LEN:
        raise DecodeError("decoded stream shorter than header")
    header = Header.from_bytes(raw_bytes[:HEADER_LEN].tobytes())
    # Vec::truncate caps at the available length
    n = min(header.packet_length, raw_bytes.shape[-1] - HEADER_LEN)
    payload = raw_bytes[HEADER_LEN:HEADER_LEN + n]
    if return_diagnostics:
        diag["offset"] = offset
        return payload, diag
    return payload
