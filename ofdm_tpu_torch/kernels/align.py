"""Frame alignment kernels of ofdm_tpu/kernels/align_pallas.py, with their
plain versions:

- ``sync_align`` (kernel 1, ``csrc/sync_align.cu``): fused sync + window copy,
  in one kernel (``sync_align_one_pass``) for the rows ``one_pass_cluster``
  takes, in two otherwise;
- ``planar_align`` (kernel 3, same library): the window copy alone, at
  offsets computed outside (the unfused route), from rows or from one
  shared stream (stream decoding);
- ``pin_rowmajor`` (kernel 5, ``csrc/pin_rowmajor.cu``): a row-major copy of
  a strided view;
- ``sync_keys`` (``sync_align.cu``, no TPU kernel): kernel 1's correlation
  pass alone, one packed (power, lag) key per row, for the time-sharded
  sync of ``parallel/``.

``sync_align``, replacing ``align_pallas.py::sync_align``.  Per row: correlate the
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
equally valid, lag (ofdm_tpu_torch/PARITY.md).
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


def check_input(flat: torch.Tensor, what: str):
    """(rows, T) of a contiguous complex64 [R, T] or f32 [R, 2, T] input."""
    if flat.dtype == torch.complex64 and flat.dim() == 2:
        r, t = flat.shape
    elif flat.dtype == torch.float32 and flat.dim() == 3 and flat.shape[1] == 2:
        r, _, t = flat.shape
    else:
        raise ValueError(f"{what} takes complex64 [R, T] or float32 "
                         f"[R, 2, T], got {flat.dtype} {tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError(f"{what} needs a contiguous input")
    return r, t


def _check(flat: torch.Tensor, template, need: int, search_window):
    """Validate the arguments; return (rows, T, complex64 template, lag_bound)."""
    r, t = check_input(flat, "sync_align")
    tpl = np.asarray(template).astype(np.complex64)
    if tpl.ndim != 1 or tpl.shape[0] == 0:
        raise ValueError("the template must be a non-empty 1-D array")
    k = tpl.shape[0]
    if k > MAX_TAPS:
        raise NotImplementedError(
            f"sync_align takes templates of at most {MAX_TAPS} taps; longer "
            "ones take the unfused route: ops.xcorr.locking_sync_offset, "
            "then planar_align")
    if not 0 < need <= t:
        raise ValueError(f"need={need} must lie in [1, T={t}]")
    lag_bound = t if search_window is None else min(t, search_window + k)
    if lag_bound < 1:
        raise ValueError(f"search_window={search_window} leaves no lag to scan")
    return r, t, tpl, lag_bound


def window_strides(x: torch.Tensor):
    """(row, plane, element) strides in floats of a complex64 [R, n] or an
    f32 [R, 2, n] tensor."""
    if x.dtype == torch.complex64:
        return x.shape[1] * 2, 1, 2
    return x.stride(0), x.stride(1), x.stride(2)


def reference_power(flat: torch.Tensor, tpl: np.ndarray,
                    lag_bound: int) -> torch.Tensor:
    """|c[lag]|^2 for lags < lag_bound, f32 [R, lag_bound], by
    ``locking_sync_offset``'s matmul correlation."""
    t = flat.shape[-1]
    cplx = torch.complex(flat[:, 0], flat[:, 1]) if flat.dim() == 3 else flat
    # lags < lag_bound only read samples below lag_bound + K - 1
    c = sliding_correlation_matmul(cplx[:, :min(t, lag_bound + len(tpl) - 1)],
                                   tpl)[:, :lag_bound]
    return c.real ** 2 + c.imag ** 2


def reference_offsets(flat: torch.Tensor, tpl: np.ndarray,
                      lag_bound: int) -> torch.Tensor:
    """The kernels' raw offsets the plain way: ``locking_sync_offset``'s
    matmul correlation restricted to lags < lag_bound, argmax - 1 (int64)."""
    return torch.argmax(reference_power(flat, tpl, lag_bound), dim=-1) - 1


def _gather_windows(flat: torch.Tensor, off: torch.Tensor, need: int,
                    planar: bool) -> torch.Tensor:
    """Row r of complex64 [R, T] or f32 [R, 2, T] from off[r], ``need``
    samples, as complex64 [R, need] or f32 planes [R, 2, need]."""
    r = flat.shape[0]
    idx = off[:, None].long() + torch.arange(need, device=flat.device)
    if flat.dim() == 3:
        win = flat.gather(2, idx[:, None, :].expand(r, 2, need))  # [R, 2, need]
        return win if planar else torch.complex(win[:, 0], win[:, 1])
    win = torch.view_as_real(flat).gather(
        1, idx[:, :, None].expand(r, need, 2))                    # [R, need, 2]
    return win.permute(0, 2, 1).contiguous() if planar \
        else torch.view_as_complex(win.contiguous())


def sync_align_reference(flat: torch.Tensor, template, need: int,
                         search_window: int | None = None,
                         planar: bool = False):
    """Plain version of ``sync_align``: ``reference_offsets``, clip, then a
    gather."""
    _, t, tpl, lag_bound = _check(flat, template, need, search_window)
    raw = reference_offsets(flat, tpl, lag_bound)
    out = _gather_windows(flat, torch.clamp(raw, 0, t - need), need, planar)
    return out, raw.to(torch.int32)


@lru_cache(maxsize=None)
def sync_lib() -> ctypes.CDLL:
    """The ``csrc/sync_align.cu`` library (kernels 1, 3, 4 and
    ``sync_keys``), loaded once with its C signatures set."""
    lib = _build.library("sync_align")
    lib.ofdm_sync_align_n_partial.restype = ctypes.c_int
    lib.ofdm_sync_align_n_partial.argtypes = [ctypes.c_int]
    lib.ofdm_sync_align.restype = ctypes.c_int
    lib.ofdm_sync_align.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.ofdm_sync_align_one_pass.restype = ctypes.c_int
    lib.ofdm_sync_align_one_pass.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.ofdm_sync_align_one_pass_shared_bytes.restype = ctypes.c_int
    lib.ofdm_sync_align_one_pass_shared_bytes.argtypes = [ctypes.c_int] * 5
    lib.ofdm_sync_align_one_pass_prepare.restype = ctypes.c_int
    lib.ofdm_sync_align_one_pass_prepare.argtypes = []
    lib.ofdm_planar_align.restype = ctypes.c_int
    lib.ofdm_planar_align.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    lib.ofdm_sync_align_chunked.restype = ctypes.c_int
    lib.ofdm_sync_align_chunked.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4)
    lib.ofdm_sync_keys.restype = ctypes.c_int
    lib.ofdm_sync_keys.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    return lib


def template_on(tpl: np.ndarray, device: torch.device) -> torch.Tensor:
    return device_table(np.frombuffer, (template_key(tpl), np.complex128),
                        torch.complex64, device)


# K1 in one pass (``sync_window_kernel``): a thread-block cluster a row, each
# CTA staging its share of the row and a halo in shared memory.  The sizes
# mirror csrc/sync_align.cu.
LAGS_PER_THREAD = 8                  # kLagsPerThread
ONE_PASS_CLUSTERS = (1, 2, 4, 8)     # kOneMaxCluster = 8, the portable most
SM_SHARED_BYTES = 233_472            # an H100 SM's shared memory (228 KB)
# a CTA's static shared memory (1.1 KB) and the 1 KB an SM reserves a CTA
CTA_SHARED_OVERHEAD = 3_072
# CTAs of the kernel an SM holds by its registers (64 a thread, 256 threads),
# and the fewest that let one CTA's copies run under another's multiply-adds
ONE_PASS_RESIDENT = (4, 2)
# the CTAs an H100 SXM holds at once (132 SMs, 4 each): a grid of fewer
# leaves SMs idle while each CTA works through its share, where the two
# kernels spread a row over a CTA per 1,024 lags
ONE_PASS_MIN_CTAS = 132 * 4


def one_pass_shared_bytes(lag_bound: int, need: int, taps: int, max_off: int,
                          cluster: int) -> int:
    """Dynamic shared memory of one CTA of the one-pass kernel: two padded
    planes of its share P of the lags and outputs (max(lag_bound, need) /
    cluster, rounded up to 8) and the halo max(taps, max_off), one float of
    padding every 8."""
    share = -(-max(lag_bound, need) // cluster)
    share = -(-share // LAGS_PER_THREAD) * LAGS_PER_THREAD
    n = share + max(taps, max_off)
    plane = -(-(n + n // LAGS_PER_THREAD) // 4) * 4
    return 2 * 4 * plane


def _fitting_cluster(t: int, need: int, lag_bound: int,
                     taps: int) -> int | None:
    """The smallest cluster size whose CTA leaves an SM's shared memory
    room for as many CTAs as its registers allow (4), else the smallest that
    leaves room for 2; None where no size does."""
    max_off = t - need
    for resident in ONE_PASS_RESIDENT:
        for c in ONE_PASS_CLUSTERS:
            smem = one_pass_shared_bytes(lag_bound, need, taps, max_off, c)
            if resident * (smem + CTA_SHARED_OVERHEAD) <= SM_SHARED_BYTES:
                return c
    return None


def one_pass_cluster(rows: int, t: int, need: int, lag_bound: int,
                     taps: int) -> int | None:
    """The rule: the cluster size with which ``sync_align`` takes one pass
    over ``rows`` rows of T samples, or None for the two kernels.  One pass
    is taken where a cluster size fits (``_fitting_cluster``) and the grid
    of rows x size CTAs fills the card (``ONE_PASS_MIN_CTAS``).  (Measured
    on the H100, PERF.md: at 2,048 rows of 19,120 samples 4 CTAs a row take
    0.40 ms, 2 take 0.43, 8 take 0.50 and the two kernels 0.58; at 64 rows
    one pass takes 0.022 ms against 0.021.)"""
    c = _fitting_cluster(t, need, lag_bound, taps)
    return c if c is not None and rows * c >= ONE_PASS_MIN_CTAS else None


@lru_cache(maxsize=None)
def _one_pass_ready(index: int) -> None:
    """Lets the one-pass kernel take its shared memory on CUDA device
    ``index``: once, at its first launch there, which is eager (graphs
    capture a key's second call)."""
    lib = sync_lib()
    with torch.cuda.device(index):
        _build.check(lib, lib.ofdm_sync_align_one_pass_prepare(),
                     "sync_align_one_pass")


def _out(r: int, need: int, planar: bool, dev) -> torch.Tensor:
    return torch.empty((r, 2, need), dtype=torch.float32, device=dev) if planar \
        else torch.empty((r, need), dtype=torch.complex64, device=dev)


def _two_pass(flat: torch.Tensor, tpl: np.ndarray, need: int, lag_bound: int,
              planar: bool):
    """K1 as two kernels (correlation pass, then window pass) on a CUDA
    tensor: (window, raw offsets)."""
    r, t = check_input(flat, "sync_align")
    lib = sync_lib()
    dev = flat.device
    w = template_on(tpl, dev)
    partial = torch.empty((r, lib.ofdm_sync_align_n_partial(lag_bound)),
                          dtype=torch.int64, device=dev)
    raw = torch.empty(r, dtype=torch.int32, device=dev)
    out = _out(r, need, planar, dev)
    err = lib.ofdm_sync_align(
        flat.data_ptr(), *window_strides(flat), r, t, w.data_ptr(), len(tpl),
        int(_template_is_real(tpl)), lag_bound, need, t - need,
        partial.data_ptr(), raw.data_ptr(), out.data_ptr(),
        *window_strides(out), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sync_align")
    return out, raw


def sync_align(flat: torch.Tensor, template, need: int,
               search_window: int | None = None, planar: bool = False):
    """Fused sync + align: returns (window, raw_offsets).

    flat: complex64 [R, T] or f32 planes [R, 2, T], contiguous.
    template: the locking template, at most 128 taps (numpy, complex).
    window: complex64 [R, need], or f32 [R, 2, need] with ``planar=True``;
    row r holds flat[r, off : off + need] with off = clip(raw[r], 0, T - need).
    raw_offsets: int32 [R], the unclipped argmax - 1.

    A CPU tensor runs ``sync_align_reference``; a CUDA tensor launches the
    kernel (counted in ``sync_align.launches``): one kernel
    (``sync_align_one_pass``) where ``one_pass_cluster`` takes the shape,
    the correlation and window passes otherwise, with the same offsets and
    windows.  Any other device raises.
    """
    r, t, tpl, lag_bound = _check(flat, template, need, search_window)
    if flat.device.type == "cpu":
        return sync_align_reference(flat, tpl, need, search_window, planar)
    if flat.device.type != "cuda":
        raise ValueError(f"sync_align runs on cpu or cuda, not {flat.device}")
    if one_pass_cluster(r, t, need, lag_bound, len(tpl)) is None:
        out, raw = _two_pass(flat, tpl, need, lag_bound, planar)
    else:
        out, raw = sync_align_one_pass(flat, tpl, need, search_window, planar)
    sync_align.launches += 1
    return out, raw


sync_align.launches = 0


def sync_align_one_pass(flat: torch.Tensor, template, need: int,
                        search_window: int | None = None,
                        planar: bool = False):
    """``sync_align`` in one kernel: each row read once by a thread-block
    cluster, its offset agreed across the cluster and its window written
    from shared memory.  The same arguments, results and offsets as
    ``sync_align``, which calls it where ``one_pass_cluster`` says.  It
    runs any number of rows whose shape fits a cluster's shared memory, and
    raises ValueError for a shape that does not.

    A CPU tensor runs ``sync_align_reference``; a CUDA tensor launches the
    kernel (counted in ``sync_align_one_pass.launches``; ``sync_align``
    counts its own calls); any other device raises.
    """
    r, t, tpl, lag_bound = _check(flat, template, need, search_window)
    if flat.device.type == "cpu":
        return sync_align_reference(flat, tpl, need, search_window, planar)
    if flat.device.type != "cuda":
        raise ValueError(f"sync_align_one_pass runs on cpu or cuda, not "
                         f"{flat.device}")
    cluster = _fitting_cluster(t, need, lag_bound, len(tpl))
    if cluster is None:
        raise ValueError(f"rows of T={t} (need={need}, lag_bound={lag_bound}, "
                         f"{len(tpl)} taps) do not fit one pass; sync_align "
                         "takes two kernels there")
    lib = sync_lib()
    dev = flat.device
    _one_pass_ready(dev.index)
    w = template_on(tpl, dev)
    raw = torch.empty(r, dtype=torch.int32, device=dev)
    out = _out(r, need, planar, dev)
    err = lib.ofdm_sync_align_one_pass(
        flat.data_ptr(), *window_strides(flat), r, t, w.data_ptr(), len(tpl),
        int(_template_is_real(tpl)), lag_bound, need, t - need, cluster,
        raw.data_ptr(), out.data_ptr(), *window_strides(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sync_align_one_pass")
    sync_align_one_pass.launches += 1
    return out, raw


sync_align_one_pass.launches = 0


KEY_LAG_MASK = 0xFFFFFFFF


def pack_keys(power: torch.Tensor, lag: torch.Tensor) -> torch.Tensor:
    """int64 keys (f32 bits of ``power`` << 32) | (0xFFFFFFFF - lag): for
    power >= 0 the keys order as (power, then the SMALLER lag), the order
    the kernels' argmax reduces in."""
    bits = power.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return ((bits & KEY_LAG_MASK) << 32) | (KEY_LAG_MASK - lag.to(torch.int64))


def argmax_keys(power: torch.Tensor, lag0=0) -> torch.Tensor:
    """The packed key of the first maximum of ``power`` over its last axis,
    its lag counted from ``lag0``."""
    lag = torch.argmax(power, dim=-1)
    return pack_keys(power.gather(-1, lag[..., None])[..., 0], lag + lag0)


def key_lag(keys: torch.Tensor) -> torch.Tensor:
    """The lag a packed key holds (int64)."""
    return KEY_LAG_MASK - (keys & KEY_LAG_MASK)


def key_power(keys: torch.Tensor) -> torch.Tensor:
    """The f32 power a packed key holds."""
    return (keys >> 32).to(torch.int32).view(torch.float32)


def _check_keys(flat: torch.Tensor, template, lag_bound: int):
    """Validate the arguments of ``sync_keys``; return (rows, T, complex64
    template)."""
    r, t = check_input(flat, "sync_keys")
    tpl = np.asarray(template).astype(np.complex64)
    if tpl.ndim != 1 or not 0 < tpl.shape[0] <= MAX_TAPS:
        raise ValueError(f"sync_keys takes a 1-D template of 1 to {MAX_TAPS} "
                         "taps; longer ones take the conv correlation")
    if not 0 < lag_bound <= t:
        raise ValueError(f"lag_bound={lag_bound} must lie in [1, T={t}]")
    return r, t, tpl


def sync_keys_reference(flat: torch.Tensor, template,
                        lag_bound: int) -> torch.Tensor:
    """Plain version of ``sync_keys``: the matmul correlation's power over
    lags < lag_bound and its first-occurrence argmax, packed."""
    _, _, tpl = _check_keys(flat, template, lag_bound)
    return argmax_keys(reference_power(flat, tpl, lag_bound))


def sync_keys(flat: torch.Tensor, template, lag_bound: int) -> torch.Tensor:
    """Per row, the packed key of the first lag of maximal correlation power
    below ``lag_bound``: K1's correlation pass and row reduce, without the
    window copy.

    flat: complex64 [R, T] or f32 planes [R, 2, T], contiguous; samples past
    T read as 0.  template: at most 128 taps.  Returns int64 [R] keys
    (``pack_keys``; ``key_lag`` and ``key_power`` read them back).  The
    time-sharded sync runs it on each haloed shard and takes the max of the
    keys, rewritten to global lags, across the time axis
    (``parallel/halo.py``).

    A CPU tensor runs ``sync_keys_reference``; a CUDA tensor launches the
    kernel (counted in ``sync_keys.launches``); any other device raises.
    The kernel sums each correlation in another order than the matmul, so
    a power may differ in its last bits and a near-exact tie may resolve
    to the other lag (ofdm_tpu_torch/PARITY.md).
    """
    r, t, tpl = _check_keys(flat, template, lag_bound)
    if flat.device.type == "cpu":
        return sync_keys_reference(flat, tpl, lag_bound)
    if flat.device.type != "cuda":
        raise ValueError(f"sync_keys runs on cpu or cuda, not {flat.device}")
    lib = sync_lib()
    dev = flat.device
    w = template_on(tpl, dev)
    partial = torch.empty((r, lib.ofdm_sync_align_n_partial(lag_bound)),
                          dtype=torch.int64, device=dev)
    keys = torch.empty(r, dtype=torch.int64, device=dev)
    err = lib.ofdm_sync_keys(
        flat.data_ptr(), *window_strides(flat), r, t, w.data_ptr(), len(tpl),
        int(_template_is_real(tpl)), lag_bound, partial.data_ptr(),
        keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sync_keys")
    sync_keys.launches += 1
    return keys


sync_keys.launches = 0


def _is_stream(x: torch.Tensor) -> bool:
    """True for one shared stream: complex64 [T] or f32 planes [2, T]."""
    return (x.dtype == torch.complex64 and x.dim() == 1) or (
        x.dtype == torch.float32 and x.dim() == 2 and x.shape[0] == 2)


def _check_planar_align(flat: torch.Tensor, offsets: torch.Tensor,
                        need: int):
    """Validate the arguments of ``planar_align``; return (rows, T, the
    input's (row, plane, element) strides in floats)."""
    if _is_stream(flat):
        t = flat.shape[-1]
        r = offsets.shape[0] if offsets.dim() == 1 else -1
        # row stride 0: every row reads the one stream, at any element stride
        strides = (0, 1, 2 * flat.stride(0)) if flat.is_complex() \
            else (0, *flat.stride())
        if t < 1 or need < 1:
            raise ValueError(f"planar_align needs T >= 1 and need >= 1, got "
                             f"T={t}, need={need}")
    else:
        r, t = check_input(flat, "planar_align")
        strides = window_strides(flat)
        if not 0 < need <= t:
            raise ValueError(f"need={need} must lie in [1, T={t}]")
    if offsets.shape != (r,) or offsets.dtype not in (torch.int32, torch.int64) \
            or offsets.device != flat.device:
        raise ValueError("offsets must be int32 or int64 [R] on the input's "
                         "device")
    return r, t, strides


def _gather_stream(stream: torch.Tensor, off: torch.Tensor, need: int,
                   planar: bool) -> torch.Tensor:
    """Row r = stream[off[r] : off[r] + need], 0 at and past T, from a
    complex64 [T] or f32 [2, T] stream; complex64 [R, need] or f32 planes
    [R, 2, need]."""
    t = stream.shape[-1]
    idx = off[:, None].long() + torch.arange(need, device=stream.device)
    inside = idx < t
    idx = idx.clamp(max=t - 1)
    if stream.dim() == 1:
        win = torch.where(inside, stream[idx], 0)                    # [R, need]
        return torch.stack([win.real, win.imag], dim=1) if planar else win
    win = torch.where(inside, stream[:, idx], 0)                     # [2, R, need]
    return win.transpose(0, 1).contiguous() if planar \
        else torch.complex(win[0], win[1])


def planar_align_reference(flat: torch.Tensor, offsets: torch.Tensor,
                           need: int, planar: bool = False) -> torch.Tensor:
    """Plain version of ``planar_align``: a gather, after checking the
    offsets the kernel trusts: every one in [0, T - need] for rows, and
    non-negative for a shared stream (whose rows read 0 past T)."""
    r, t, _ = _check_planar_align(flat, offsets, need)
    if _is_stream(flat):
        if r and not bool((offsets >= 0).all()):
            raise ValueError("offsets into a stream must be >= 0")
        return _gather_stream(flat, offsets, need, planar)
    if r and not bool(((offsets >= 0) & (offsets <= t - need)).all()):
        raise ValueError(f"offsets must lie in [0, T - need = {t - need}]")
    return _gather_windows(flat, offsets, need, planar)


def planar_align(flat: torch.Tensor, offsets: torch.Tensor, need: int,
                 planar: bool = False) -> torch.Tensor:
    """Per-row window copy (kernel 3): row r holds
    ``flat[r, offsets[r] : offsets[r] + need]``.

    flat: complex64 [R, T] or f32 planes [R, 2, T], contiguous, with
    offsets already clipped to [0, T - need] (``decode_frame`` clips; the
    kernel reads them as they are); or one shared stream, complex64 [T] or
    f32 [2, T] of any strides, that every row reads (row stride 0), with
    offsets >= 0 and samples at or past T read as 0 (stream decoding: every
    frame of a capture in one launch, no copy or padding of the stream).
    offsets: int32 or int64 [R].  Returns complex64 [R, need], or f32
    [R, 2, need] with ``planar=True``.

    A CPU tensor runs ``planar_align_reference``; a CUDA tensor launches the
    kernel (counted in ``planar_align.launches``); any other device raises.
    """
    if flat.device.type == "cpu":
        return planar_align_reference(flat, offsets, need, planar)
    if flat.device.type != "cuda":
        raise ValueError(f"planar_align runs on cpu or cuda, not {flat.device}")
    r, t, strides = _check_planar_align(flat, offsets, need)
    offs = offsets.to(torch.int32).contiguous()
    out = torch.empty((r, 2, need), dtype=torch.float32, device=flat.device) \
        if planar else torch.empty((r, need), dtype=torch.complex64,
                                   device=flat.device)
    lib = sync_lib()
    err = lib.ofdm_planar_align(
        flat.data_ptr(), *strides, r, t, offs.data_ptr(), need,
        out.data_ptr(), *window_strides(out),
        torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(lib, err, "planar_align")
    planar_align.launches += 1
    return out


planar_align.launches = 0


@lru_cache(maxsize=None)
def _pin_lib() -> ctypes.CDLL:
    lib = _build.library("pin_rowmajor")
    lib.ofdm_pin_rowmajor.restype = ctypes.c_int
    lib.ofdm_pin_rowmajor.argtypes = (
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_longlong)] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    return lib


def pin_rowmajor_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pin_rowmajor``: ``x.contiguous()``, always a new
    tensor (cloned when ``x`` is already row-major)."""
    return x.clone(memory_format=torch.contiguous_format)


def pin_rowmajor(x: torch.Tensor) -> torch.Tensor:
    """A row-major copy of a 2-D to 4-D tensor of any strides (kernel 5).

    The GPU form of the TPU's layout pin: a strided planar view, such as
    ``torch.view_as_real(rx).transpose(1, 2)``, made into the contiguous
    [R, 2, T] planes the decode kernels read.  Elements of 1, 2, 4 or 8
    bytes.  Always returns a new tensor.

    A CPU tensor runs ``pin_rowmajor_reference``; a CUDA tensor launches the
    kernel (counted in ``pin_rowmajor.launches``); any other device raises.
    """
    if not 2 <= x.dim() <= 4:
        raise ValueError(f"pin_rowmajor takes 2-D to 4-D tensors, got {x.dim()}-D")
    if x.device.type == "cpu":
        return pin_rowmajor_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pin_rowmajor runs on cpu or cuda, not {x.device}")
    size = x.element_size()
    if size not in (1, 2, 4, 8) or x.data_ptr() % size:
        raise ValueError(f"pin_rowmajor copies aligned 1, 2, 4 or 8-byte "
                         f"elements, not {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lead = 4 - x.dim()
    sizes = (ctypes.c_longlong * 4)(*([1] * lead + list(x.shape)))
    strides = (ctypes.c_longlong * 4)(*([0] * lead + list(x.stride())))
    lib = _pin_lib()
    err = lib.ofdm_pin_rowmajor(x.data_ptr(), sizes, strides, size,
                                 out.data_ptr(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "pin_rowmajor")
    pin_rowmajor.launches += 1
    return out


pin_rowmajor.launches = 0
