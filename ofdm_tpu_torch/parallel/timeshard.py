"""Time-sharded full-chain decode and channel (port of ofdm_tpu/parallel/timeshard.py).

Sequence parallelism through the whole receive chain: each rank holds a
[B_loc, T_loc] shard of the sample stream (rows over ``data``, samples over
``time``) and only halos, the sync chunks, packed keys and decoded bytes
cross ranks; the sample axis is never gathered.  Per shard:

1. ONE right halo of ``sym_len - 1`` samples serves both the sync
   correlation (80-tap locking template, src/receiver.rs:20-25) and the
   symbol spill: after alignment every shard holds the whole symbols whose
   starts fall in its sample range.
2. ``sync_keys`` (K1's correlation pass) gives each row's packed (power,
   lag) key over the shard's lags; the rank rewrites the lag as a global
   lag and one all_reduce(MAX) over time gives the first global argmax.
   A search window clips each shard's lag bound (to 0 past the window,
   where the shard offers the key of power 0 at its first lag).  Templates
   over 128 taps take the conv correlation (a route chosen by length).
3. ``planar_align`` (K3) copies each row's M whole local symbols out of the
   haloed shard at offset ``(off - s0) mod sym_len``.
4. The 10 sync chunks (src/transmitter.rs:21-34): each shard writes the
   chunks it owns into zeros and one all_reduce(SUM) over time assembles
   them on every shard, exactly (each chunk has one owner).  CFO
   (src/receiver.rs:231-240) and the channel estimate (:212-229) are then
   computed on every shard by ``phy/front.py``.
5. Each shard derotates and DFTs (the ``derot_dft`` kernel, full fp32),
   equalizes, removes the pilot phase and demodulates ONLY its local
   symbols, with the symbol's global chunk index for the CFO phase.  The
   JAX tail is XLA, not a Pallas kernel; K2's fixed per-block phase cannot
   take a per-row chunk shift, so this tail is plain torch.
6. Decoded bytes go into zeros at their block and one all_reduce(SUM) over
   time assembles them (exact: each byte has one owner); Hamming runs
   after that sum, with no further collective.

Byte identity with the single-device ``decode_frame`` across offsets that
straddle shard boundaries is held by tests/test_torch_timeshard.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..fec import hamming
from ..kernels.align import (argmax_keys, key_lag, pack_keys, planar_align,
                              sync_keys)
from ..ops.convolve import convolve_direct
from ..ops.fft import dft_matmul_select_planar, real_dtype, require_full_fp32
from ..ops.xcorr import MAX_TAPS, sliding_correlation
from ..phy import front
from ..phy.modulation import (BITS_PER_SYMBOL, Modulation, _pad_last,
                              demodulate_symbols_packed)
from ..phy.rx import locking_template
from .halo import all_reduce, global_key_max, left_halo, right_halo
from .mesh import (DATA_AXIS, TIME_AXIS, axis_index, axis_size, shard,
                   time_sharding)


def _bytes_per_block(cfg: FrameConfig, guard_bands: bool,
                     modulation: Modulation) -> int:
    nd = cfg.carriers_per_block(guard_bands)
    bits = nd * BITS_PER_SYMBOL[modulation]
    if bits % 8:
        raise ValueError(
            f"time-sharded decode needs whole-byte blocks: {nd} carriers x "
            f"{BITS_PER_SYMBOL[modulation]} bits/sym = {bits} bits/block")
    return bits // 8


def shard_sync_keys(ext: torch.Tensor, template: np.ndarray, lag_bound: int,
                    lag0: int) -> torch.Tensor:
    """Packed keys int64 [B] of the haloed shard ``ext``'s lags
    [0, lag_bound), each lag rewritten as the global lag ``lag0 + lag``.

    ``sync_keys`` (K1's pass) for templates of at most 128 taps, the conv
    correlation for longer ones; a bound of 0 (a shard past the search
    window) gives the key of power 0 at the shard's first lag, which loses
    to any lag of a shard before it."""
    b = ext.shape[0]
    if lag_bound <= 0:
        return pack_keys(torch.zeros(b, device=ext.device),
                         torch.full((b,), lag0, device=ext.device))
    if len(template) <= MAX_TAPS:
        # low 32 bits hold 0xFFFFFFFF - lag: a global lag lag0 + lag is the
        # key minus lag0
        return sync_keys(ext, template, lag_bound) - lag0
    k = len(template)
    c = sliding_correlation(ext, template)[:, k - 1:k - 1 + lag_bound]
    return argmax_keys(c.real ** 2 + c.imag ** 2, lag0)


def _haloed(shard_: torch.Tensor, mesh, halo: int) -> torch.Tensor:
    """The shard with its right halo; the last shard's (the ring's wrap of
    the first shard's head) zeroed, so windows past the stream read zeros,
    as ``decode_frame``'s padding."""
    ext = right_halo(shard_, halo, mesh)
    if axis_index(mesh, TIME_AXIS) == axis_size(mesh, TIME_AXIS) - 1:
        ext[:, shard_.shape[-1]:] = 0
    return ext


def timesharded_decode_fn(mesh, *, n_blocks: int, guard_bands: bool,
                          modulation: Modulation,
                          cfg: FrameConfig = DEFAULT_CONFIG,
                          cfo_estimator: str = "coherent",
                          search_window: int | None = None,
                          fec: str | None = None,
                          payload_len: int = 0, data_len: int = 0,
                          derot_impl: str = "auto"):
    """Build the per-rank decode: this rank's complex shard [B_loc, T_loc]
    (T_loc a multiple of sym_len) -> uint8 [B_loc, n_bytes], the same on
    every rank of a time line.

    ``search_window`` bounds the sync scan to global frame starts below
    search_window + sym_len, as ``decode_frame``'s truncated scan does
    (near the window's edge the shards see the real stream where
    decode_frame sees zeros, so a near-peak there may differ; in-window
    peaks decode byte-identically).  ``fec="hamming"`` runs the Hamming(7,4)
    tail on the assembled bytes and returns uint8 [B_loc, data_len] user
    bytes.  ``derot_impl``: "auto" (= "matrix": the CFO phasor folded into
    the per-row DFT matrix) or "stream" (the windows rotated first)."""
    if fec not in (None, "hamming"):
        raise ValueError(f"timesharded fec supports None/'hamming', got {fec!r}")
    if fec == "hamming" and not (payload_len and data_len):
        raise ValueError("fec='hamming' needs payload_len and data_len")
    derot = front.resolve_derot(derot_impl)
    sym, cp = cfg.sym_len, cfg.cp_len
    n_sync = cfg.n_sync_chunks
    need = (n_sync + n_blocks) * sym
    n_time = axis_size(mesh, TIME_AXIS)
    bpb = _bytes_per_block(cfg, guard_bands, modulation)
    template = locking_template(cfg).astype(np.complex64)
    sel, nd, n_pilots = front.selected_bins(guard_bands, cfg)
    left, right, train = front.estimate_chunks(cfg)

    def local_fn(shard_: torch.Tensor) -> torch.Tensor:
        b_loc, t_loc = shard_.shape
        if t_loc % sym:
            raise ValueError(f"local shard {t_loc} not a symbol multiple")
        m = t_loc // sym
        t_glob = t_loc * n_time
        if t_glob < need:
            raise ValueError(f"stream {t_glob} shorter than frame {need}")
        dev = shard_.device
        require_full_fp32(dev)
        s0 = axis_index(mesh, TIME_AXIS) * t_loc

        # --- one halo serves the sync windows AND the symbol spill --------
        ext = _haloed(shard_.to(torch.complex64).contiguous(), mesh, sym - 1)

        # --- sync: K1's pass per shard, one all_reduce(MAX) of the keys ---
        bound = t_loc if search_window is None else \
            min(t_loc, max(0, search_window + sym - s0))
        keys = global_key_max(shard_sync_keys(ext, template, bound, s0), mesh)
        off = (key_lag(keys) - 1).clamp(0, t_glob - need)            # [B]

        # --- the M whole local symbols from l0 = (off - s0) mod sym --------
        d = off - s0
        c0 = torch.div(d, sym, rounding_mode="floor")                 # [B]
        planes = planar_align(ext, d - c0 * sym, m * sym, planar=True)
        planes = planes.reshape(b_loc, 2, m, sym)
        cidx = torch.arange(m, device=dev)[None, :] - c0[:, None]     # [B, M]

        # --- the sync chunks: owned ones into zeros, summed over time ------
        src = torch.arange(n_sync, device=dev)[None, :] + c0[:, None]
        own = (src >= 0) & (src < m)
        idx = src.clamp(0, m - 1)[:, None, :, None].expand(b_loc, 2, n_sync, sym)
        sync = torch.where(own[:, None, :, None], planes.gather(2, idx), 0.0)
        sync = all_reduce(sync, mesh)                       # [B, 2, n_sync, sym]
        sc = torch.complex(sync[:, 0], sync[:, 1])

        # --- CFO and channel estimate on every shard ------------------------
        f_delta, h_k = front.estimates(sc[:, left], sc[:, right], sc[:, train, cp:],
                                       cfg=cfg, cfo_estimator=cfo_estimator)
        h_sel = front.h_selected(h_k, guard_bands, cfg)[0]

        # --- local symbols: derotate, DFT, equalize, pilot phase, demod -----
        rd = f_delta.dtype
        chunk_angle = f_delta[:, None] * (cidx.to(rd) * sym)          # [B, M]
        if derot == "matrix":
            yr, yi = front.derot_spectrum(planes[:, 0], planes[:, 1], f_delta,
                                          guard_bands=guard_bands, cfg=cfg)
            y = torch.complex(yr, yi) * front.phasor(chunk_angle)[..., None]
        else:
            rot_j = front.phasor(f_delta[:, None]
                                 * torch.arange(sym, dtype=rd, device=dev))
            win = torch.complex(planes[:, 0], planes[:, 1]) * (
                front.phasor(chunk_angle)[..., None] * rot_j[:, None, :])
            yr, yi = dft_matmul_select_planar(win[..., cp:], sel)
            y = torch.complex(yr, yi)
        eq = y / h_sel[:, None, :]
        syms = eq[..., :nd]
        if n_pilots:
            phi = torch.angle(eq[..., nd:nd + n_pilots]).mean(-1, keepdim=True)
            syms = syms * front.phasor(phi)
        by = demodulate_symbols_packed(syms, modulation)           # [B, M, bpb]

        # --- bytes: owned blocks into zeros, summed over time ---------------
        src = torch.arange(n_blocks, device=dev)[None, :] + n_sync + c0[:, None]
        own = (src >= 0) & (src < m)
        idx = src.clamp(0, m - 1)[..., None].expand(b_loc, n_blocks, bpb)
        out = torch.where(own[..., None], by.gather(1, idx), 0)
        out = all_reduce(out.to(torch.uint8), mesh).reshape(b_loc,
                                                            n_blocks * bpb)
        if fec == "hamming":
            h0 = cfg.header_len_bytes
            out = hamming.decode(out[:, h0:h0 + payload_len], data_len)
        return out

    return local_fn


def _shard_seed(seed: int, *parts: int) -> int:
    """A generator seed for one shard's draws, from the step's seed and the
    shard's (kind, data index[, time index])."""
    return int(np.random.SeedSequence([seed, *parts]).generate_state(
        1, np.uint64)[0])


def channel_timesharded_fn(mesh, *, snr: float | None = 30.0,
                           timing_error: bool = False,
                           cfg: FrameConfig = DEFAULT_CONFIG):
    """Build the per-rank channel: (this rank's complex shard [B_loc, T_loc],
    an int seed alike on every rank) -> the received shard [B_loc, T_loc].

    - A 63-sample LEFT halo completes the multipath convolution window (64
      taps, src/channel.rs:26-31); the first shard sees zero history, as the
      linear convolution's zero-padded start.  The output is the first T
      samples of the full convolution: the input must end in >= 63 zeros
      (the pipeline's padding) for nothing to be lost.
    - The CFO rotation uses the GLOBAL sample index (src/channel.rs:48-63),
      drawn per row from a generator seeded by (seed, data index), so every
      time shard of a row agrees.
    - The noise amplitude's complex pseudo-variance (src/channel.rs:66-71)
      is a global reduction: two all_reduce(SUM)s over time, the mean and
      then the variance.
    - Each shard draws its noise from a generator seeded by (seed, data
      index, time index): the same distribution as ``channel``, another
      realization (ofdm_tpu_torch/PARITY.md).

    ``snr=None`` turns the noise off."""
    n_time = axis_size(mesh, TIME_AXIS)
    k = constants.CHANNEL_TAPS.shape[-1]

    def local_fn(shard_: torch.Tensor, seed: int) -> torch.Tensor:
        b_loc, t_loc = shard_.shape
        dev = shard_.device
        rd = real_dtype(shard_.dtype)
        my_t = axis_index(mesh, TIME_AXIS)
        my_d = axis_index(mesh, DATA_AXIS)
        ext = left_halo(shard_.contiguous(), k - 1, mesh)
        if my_t == 0:
            ext[:, :k - 1] = 0
        taps = torch.as_tensor(constants.CHANNEL_TAPS, dtype=rd, device=dev)
        out = convolve_direct(ext, taps)[:, k - 1:k - 1 + t_loc]
        if timing_error:
            g = torch.Generator(dev).manual_seed(_shard_seed(seed, 0, my_d))
            f_delta = math.pi * torch.rand(b_loc, generator=g, dtype=rd,
                                           device=dev) / 80.0
            n = (torch.arange(1, t_loc + 1, device=dev) + my_t * t_loc).to(rd)
            angle = f_delta[:, None] * n
            out = out * torch.polar(torch.ones_like(angle), angle)
        if snr is not None:
            t_glob = t_loc * n_time
            mean = all_reduce(out.sum(-1), mesh) / t_glob
            diff = mean[:, None] - out
            var = all_reduce((diff * diff).sum(-1), mesh) / t_glob
            amp = torch.sqrt(0.5 * var / 10.0 ** (snr / 10.0))
            g = torch.Generator(dev).manual_seed(_shard_seed(seed, 1, my_d, my_t))
            uni = torch.rand((b_loc, t_loc, 2), generator=g, dtype=rd,
                             device=dev) * 2.0 - 1.0
            out = out + amp[:, None] * torch.complex(uni[..., 0], uni[..., 1])
        return out

    return local_fn


def decode_frame_timesharded(samples: torch.Tensor, mesh, *, n_blocks: int,
                             guard_bands: bool = False,
                             modulation: Modulation = Modulation.BPSK,
                             cfg: FrameConfig = DEFAULT_CONFIG,
                             cfo_estimator: str = "coherent",
                             search_window: int | None = None,
                             fec: str | None = None,
                             payload_len: int = 0,
                             data_len: int = 0,
                             derot_impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel batched decode: the global complex [B, T] (or [T])
    -> uint8 [B_loc, n_bytes], this rank's rows (the same on every rank of
    a time line).  Byte-identical to ``phy.rx.decode_frame`` with the sample
    axis sharded over the mesh's ``time`` axis and rows over ``data``.

    The stream is zero-padded to a multiple of time ranks x sym_len (at
    least one frame); B must divide over the data axis.  ``search_window``
    and ``fec`` as in ``timesharded_decode_fn``."""
    x = samples if isinstance(samples, torch.Tensor) else torch.as_tensor(
        np.asarray(samples))
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    n_time = axis_size(mesh, TIME_AXIS)
    need = (cfg.n_sync_chunks + n_blocks) * cfg.sym_len
    quant = n_time * cfg.sym_len
    t_to = -(-max(x.shape[-1], need) // quant) * quant
    local = shard(_pad_last(x, t_to - x.shape[-1]), time_sharding(mesh))
    out = timesharded_decode_fn(
        mesh, n_blocks=n_blocks, guard_bands=guard_bands,
        modulation=modulation, cfg=cfg, cfo_estimator=cfo_estimator,
        search_window=search_window, fec=fec, payload_len=payload_len,
        data_len=data_len, derot_impl=derot_impl)(local)
    return out[0] if squeeze else out
