"""Sync + align into slot-major chunk planes: the ``sync_align_chunked``
kernel and its plain version.

Kernel 4 of the port (``csrc/sync_align.cu``, ``ofdm_sync_align_chunked``),
replacing the TPU kernel ``ofdm_tpu/kernels/chain_pallas.py::
sync_align_chunked``.  It runs kernel 1's sync (the same correlation pass),
then writes the aligned window regrouped into two f32 planes
[R, slots, 128]: chunk c (``sym_len`` samples) sits at slot
``(c % n_cls) * m_per + c // n_cls``, lanes 0:sym_len, so the decode tail
(``phy.rx.decode_chunked_matrix``) reads every chunk as a plain lane slice.

What the port writes in the other lanes: slot s, lane j holds
``stream[off + sym_len * chunk(s) + j]``, or 0 past the row's end, for every
slot and all 128 lanes, with chunk(s) = (s % m_per) * n_cls + s // m_per
(slots past the frame's chunks included).  That is what the TPU kernel
writes too (its window reads the zero-padded stream), and the tests hold
all of it bitwise.

Deliberate differences from the TPU kernel (ofdm_tpu_torch/PARITY.md): the
offset is clipped to [0, T - need], as kernel 1 clips it, not to the TPU
tiling's ``min(T - need, (tiles - k_pad - 1) * 128 - 1)``, which only binds
on pre-tiled planar input; and the pre-tiled input form is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import torch

from ..config import DEFAULT_CONFIG, FrameConfig
from ..ops.xcorr import _template_is_real
from . import _build
from .align import (_check, _gather_windows, reference_offsets, sync_lib,
                    template_on, window_strides)

LANES = 128


@lru_cache(maxsize=None)
def class_geometry(sym: int, n_chunks: int) -> tuple[int, int]:
    """(n_cls, m_per) of ofdm_tpu/kernels/chain_pallas.py::_class_geometry:
    chunks fall into n_cls lane-phase classes; m_per slots per class,
    rounded up to a multiple of 8 (sym 80 gives 8 classes of 32 slots)."""
    n_cls = LANES // gcd(sym, LANES)
    m_per = -(-n_chunks // n_cls)
    return n_cls, -(-m_per // 8) * 8


def _chunk_of_slot(slots: int, n_cls: int, m_per: int,
                   device: torch.device) -> torch.Tensor:
    s = torch.arange(slots, device=device)
    return (s % m_per) * n_cls + s // m_per


def _args(flat, template, n_chunks, cfg, search_window):
    sym = cfg.sym_len
    if sym > LANES:
        raise ValueError(f"sync_align_chunked needs sym_len <= {LANES}, "
                         f"got {sym}")
    need = n_chunks * sym
    r, t, tpl, lag_bound = _check(flat, template, need, search_window)
    n_cls, m_per = class_geometry(sym, n_chunks)
    return r, t, tpl, lag_bound, need, n_cls, m_per


def sync_align_chunked_reference(flat: torch.Tensor, template, *,
                                 n_chunks: int,
                                 cfg: FrameConfig = DEFAULT_CONFIG,
                                 search_window: int | None = None):
    """Plain version of ``sync_align_chunked``: kernel 1's plain offsets,
    clip, then one gather of every slot's 128 lanes from the zero-padded
    stream."""
    r, t, tpl, lag_bound, need, n_cls, m_per = _args(
        flat, template, n_chunks, cfg, search_window)
    slots = n_cls * m_per
    off = torch.clamp(reference_offsets(flat, tpl, lag_bound), 0, t - need)
    # the slots reach span >= need samples past the offset: zeros past T
    span = cfg.sym_len * (slots - 1) + LANES
    padded = torch.cat([flat, flat.new_zeros((*flat.shape[:-1], span - need))],
                       dim=-1)
    start = cfg.sym_len * _chunk_of_slot(slots, n_cls, m_per, flat.device)
    lanes = (start[:, None] + torch.arange(LANES, device=flat.device)).reshape(-1)
    win = _gather_windows(padded, off, span, planar=True)        # [R, 2, span]
    planes = win[:, :, lanes].reshape(r, 2, slots, LANES)
    return (planes[:, 0].contiguous(), planes[:, 1].contiguous()), slots, m_per


def sync_align_chunked(flat: torch.Tensor, template, *, n_chunks: int,
                       cfg: FrameConfig = DEFAULT_CONFIG,
                       search_window: int | None = None):
    """Fused sync + align into slot-major chunk planes.

    flat: complex64 [R, T] or f32 planes [R, 2, T], contiguous, T >= need =
    n_chunks * sym_len.  template: the locking template, at most 128 taps.
    Returns ((re, im), slots, m_per): re and im f32 [R, slots, 128] (see
    the module docstring for the layout), as the TPU kernel returns them.

    A CPU tensor runs ``sync_align_chunked_reference``; a CUDA tensor
    launches the kernel (counted in ``sync_align_chunked.launches``); any
    other device raises.
    """
    r, t, tpl, lag_bound, need, n_cls, m_per = _args(
        flat, template, n_chunks, cfg, search_window)
    if flat.device.type == "cpu":
        return sync_align_chunked_reference(flat, tpl, n_chunks=n_chunks,
                                            cfg=cfg, search_window=search_window)
    if flat.device.type != "cuda":
        raise ValueError(f"sync_align_chunked runs on cpu or cuda, not "
                         f"{flat.device}")
    slots = n_cls * m_per
    lib = sync_lib()
    dev = flat.device
    w = template_on(tpl, dev)
    partial = torch.empty((r, lib.ofdm_sync_align_n_partial(lag_bound)),
                          dtype=torch.int64, device=dev)
    re = torch.empty((r, slots, LANES), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    err = lib.ofdm_sync_align_chunked(
        flat.data_ptr(), *window_strides(flat), r, t, w.data_ptr(), len(tpl),
        int(_template_is_real(tpl)), lag_bound, t - need, cfg.sym_len, n_cls,
        m_per, partial.data_ptr(), re.data_ptr(), im.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sync_align_chunked")
    sync_align_chunked.launches += 1
    return (re, im), slots, m_per


sync_align_chunked.launches = 0
