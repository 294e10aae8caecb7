"""Fused frame sync + alignment: the ``sync_align`` kernel and its plain version.

Kernel 1 of the port (``csrc/sync_align.cu``), replacing the TPU kernel
``ofdm_tpu/kernels/align_pallas.py::sync_align``.  Per row: correlate the
stream with the locking template (at most 128 taps), take the first lag of
maximal power below ``lag_bound``, and copy the ``need``-sample window that
starts one sample before it (the reference's argmax - 1, src/receiver.rs:20-25),
clipped to [0, T - need].

The window comes back as complex64 [R, need] or, with ``planar=True``, as
f32 planes [R, 2, need] that the matrix-derot DFT reads with no complex
intermediate.  The unclipped offsets come back too: the host-parity
``decode`` needs them for its -1 -> 0 clamp and range check.

Deliberate difference from the TPU kernel: the TPU's pre-tiled planar input
contract (T a multiple of 128 with a spare zero tile, which also narrows the
lag range) is not ported; every input here scans lags [0, lag_bound) with
``lag_bound = min(T, search_window + K)``.

The kernel sums each correlation in another order than the plain version's
matmul, so a near-exact tie between two peak lags may resolve to the other,
equally valid, lag (docs/PARITY.md).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..ops.fft import device_table
from ..ops.xcorr import (MAX_TAPS, _template_is_real, sliding_correlation_matmul,
                         template_key)
from . import _build


def _check(flat: torch.Tensor, template, need: int, search_window):
    """Validate the arguments; return (rows, T, complex64 template, lag_bound)."""
    if flat.dtype == torch.complex64 and flat.dim() == 2:
        r, t = flat.shape
    elif flat.dtype == torch.float32 and flat.dim() == 3 and flat.shape[1] == 2:
        r, _, t = flat.shape
    else:
        raise ValueError("sync_align takes complex64 [R, T] or float32 "
                         f"[R, 2, T], got {flat.dtype} {tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError("sync_align needs a contiguous input")
    tpl = np.asarray(template).astype(np.complex64)
    if tpl.ndim != 1 or tpl.shape[0] == 0:
        raise ValueError("the template must be a non-empty 1-D array")
    k = tpl.shape[0]
    if k > MAX_TAPS:
        raise NotImplementedError(
            f"sync_align takes templates of at most {MAX_TAPS} taps; longer "
            "ones need the unfused route (sync, then the planar_align copy, "
            "K3 in ROADMAP.md Queue 2), which is not ported yet")
    if not 0 < need <= t:
        raise ValueError(f"need={need} must lie in [1, T={t}]")
    lag_bound = t if search_window is None else min(t, search_window + k)
    if lag_bound < 1:
        raise ValueError(f"search_window={search_window} leaves no lag to scan")
    return r, t, tpl, lag_bound


def _window_strides(x: torch.Tensor):
    """(row, plane, element) strides in floats of a complex64 [R, n] or an
    f32 [R, 2, n] tensor."""
    if x.dtype == torch.complex64:
        return x.shape[1] * 2, 1, 2
    return x.stride(0), x.stride(1), x.stride(2)


def sync_align_reference(flat: torch.Tensor, template, need: int,
                         search_window: int | None = None,
                         planar: bool = False):
    """Plain version of ``sync_align``: ``locking_sync_offset``'s matmul
    correlation restricted to lags < lag_bound, clip, then a gather."""
    r, t, tpl, lag_bound = _check(flat, template, need, search_window)
    planar_in = flat.dim() == 3
    cplx = torch.complex(flat[:, 0], flat[:, 1]) if planar_in else flat
    # lags < lag_bound only read samples below lag_bound + K - 1
    c = sliding_correlation_matmul(cplx[:, :min(t, lag_bound + len(tpl) - 1)],
                                   tpl)[:, :lag_bound]
    raw = torch.argmax(c.real ** 2 + c.imag ** 2, dim=-1) - 1
    off = torch.clamp(raw, 0, t - need)
    idx = off[:, None] + torch.arange(need, device=flat.device)
    if planar_in:
        win = flat.gather(2, idx[:, None, :].expand(r, 2, need))  # [R, 2, need]
        out = win if planar else torch.complex(win[:, 0], win[:, 1])
    else:
        win = torch.view_as_real(flat).gather(
            1, idx[:, :, None].expand(r, need, 2))                # [R, need, 2]
        out = win.permute(0, 2, 1).contiguous() if planar \
            else torch.view_as_complex(win.contiguous())
    return out, raw.to(torch.int32)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("sync_align")
    lib.ofdm_sync_align_n_partial.restype = ctypes.c_int
    lib.ofdm_sync_align_n_partial.argtypes = [ctypes.c_int]
    lib.ofdm_sync_align.restype = ctypes.c_int
    lib.ofdm_sync_align.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    return lib


def _template_on(tpl: np.ndarray, device: torch.device) -> torch.Tensor:
    return device_table(np.frombuffer, (template_key(tpl), np.complex128),
                        torch.complex64, device)


def sync_align(flat: torch.Tensor, template, need: int,
               search_window: int | None = None, planar: bool = False):
    """Fused sync + align: returns (window, raw_offsets).

    flat: complex64 [R, T] or f32 planes [R, 2, T], contiguous.
    template: the locking template, at most 128 taps (numpy, complex).
    window: complex64 [R, need], or f32 [R, 2, need] with ``planar=True``;
    row r holds flat[r, off : off + need] with off = clip(raw[r], 0, T - need).
    raw_offsets: int32 [R], the unclipped argmax - 1.

    A CPU tensor runs ``sync_align_reference``; a CUDA tensor launches the
    kernel (counted in ``sync_align.launches``); any other device raises.
    """
    r, t, tpl, lag_bound = _check(flat, template, need, search_window)
    if flat.device.type == "cpu":
        return sync_align_reference(flat, tpl, need, search_window, planar)
    if flat.device.type != "cuda":
        raise ValueError(f"sync_align runs on cpu or cuda, not {flat.device}")
    lib = _lib()
    dev = flat.device
    w = _template_on(tpl, dev)
    partial = torch.empty((r, lib.ofdm_sync_align_n_partial(lag_bound)),
                          dtype=torch.int64, device=dev)
    raw = torch.empty(r, dtype=torch.int32, device=dev)
    out = torch.empty((r, 2, need), dtype=torch.float32, device=dev) if planar \
        else torch.empty((r, need), dtype=torch.complex64, device=dev)
    err = lib.ofdm_sync_align(
        flat.data_ptr(), *_window_strides(flat), r, t, w.data_ptr(), len(tpl),
        int(_template_is_real(tpl)), lag_bound, need, t - need,
        partial.data_ptr(), raw.data_ptr(), out.data_ptr(),
        *_window_strides(out), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sync_align")
    sync_align.launches += 1
    return out, raw


sync_align.launches = 0
