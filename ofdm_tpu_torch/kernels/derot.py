"""The matrix-derot front half's DFT at the selected bins in one pass: the
``derot_dft`` kernel (``csrc/derot_dft.cu``).

It replaces no TPU kernel: the JAX package left this product to XLA
(``ofdm_tpu/ops/fft.py::dft_matmul_select_derot_planar``, a per-row
derotated DFT matrix and one matmul), and the port's plain version,
``ops/fft.py::dft_matmul_select_derot_planar_reference``, does the same with
two batched products.  The kernel reads the strided planes in place,
computes each row's within-symbol CFO phasor itself, derotates in registers
and splits the DFT 8 x n/8 against tables of the selected bins kept on
chip, so nothing per row is written to device memory.  All in float32, with
no TF32 and no fast-math intrinsics: the same sums of float32 products as
the plain version, in another order.

``dft_matmul_select_derot_planar``, the decode paths' entry, dispatches here.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..ops.fft import (check_derot_planar, device_table,
                       dft_matmul_select_derot_planar_reference)
from . import _build

# the n_fft the kernel is built for: the package's geometries
N_FFT = (32, 64, 80, 128, 256)
MAX_BINS = 256


@lru_cache(maxsize=None)
def kernel_bins(n: int, bins: tuple) -> np.ndarray:
    """The selected bins in [0, n), indexed as the DFT matrix's columns."""
    return np.arange(n)[list(bins)]


@lru_cache(maxsize=None)
def kernel_twiddle(n: int, bins: tuple) -> np.ndarray:
    """The kernel's column of each bin b: exp(-2 pi i (p2 b mod n) / n) for
    p2 < n / 8, as float64 [n / 8, k, 2] (re, im)."""
    p2 = np.arange(n // 8)[:, None]
    w = np.exp(-2j * np.pi * (p2 * kernel_bins(n, bins) % n) / n)
    return np.stack([w.real, w.imag], axis=-1)


def _check(xr, xi, bins, omega, sample_offset):
    check_derot_planar(xr, xi, omega)
    n = xr.shape[-1]
    if n not in N_FFT:
        raise ValueError(f"derot_dft is built for n_fft in {N_FFT}, got {n}")
    if not 0 < len(bins) <= MAX_BINS:
        raise ValueError(f"derot_dft takes 1 to {MAX_BINS} bins, got "
                         f"{len(bins)}")
    if not 0 <= sample_offset < (1 << 24) - n:
        raise ValueError(f"sample_offset {sample_offset} out of range")
    if xr.device.type != "cuda" or xr.dtype != torch.float32:
        raise ValueError("derot_dft takes float32 CUDA planes, got "
                         f"{xr.dtype} on {xr.device}")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("derot_dft")
    lib.ofdm_derot_dft.restype = ctypes.c_int
    lib.ofdm_derot_dft.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    return lib


def derot_dft(xr: torch.Tensor, xi: torch.Tensor, bins: tuple,
              omega: torch.Tensor, sample_offset: int = 0):
    """``dft_matmul_select_derot_planar`` on the card, one launch.

    xr, xi: float32 CUDA [R, C, n], any strides, n one of ``N_FFT``.
    omega: float32 [R].  bins: 1 to ``MAX_BINS`` bins.  Anything else
    raises ValueError.  Returns (yr, yi), two views of one contiguous
    [R, C, 2k] product, as the plain version does.  Counted in
    ``derot_dft.launches``; empty planes launch nothing.
    """
    bins = tuple(bins)
    _check(xr, xi, bins, omega, sample_offset)
    r, c, n = xr.shape
    k = len(bins)
    dev = xr.device
    out = torch.empty((r, c, 2 * k), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out[..., :k], out[..., k:]
    sel = device_table(kernel_bins, (n, bins), torch.int32, dev)
    twiddle = device_table(kernel_twiddle, (n, bins), torch.float32, dev)
    omega = omega.contiguous()
    lib = _lib()
    err = lib.ofdm_derot_dft(
        xr.data_ptr(), xi.data_ptr(), *xr.stride(), *xi.stride(), r, c, n, k,
        omega.data_ptr(), sample_offset, sel.data_ptr(), twiddle.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "derot_dft")
    derot_dft.launches += 1
    return out[..., :k], out[..., k:]


derot_dft.launches = 0


def dft_matmul_select_derot_planar(xr: torch.Tensor, xi: torch.Tensor,
                                   bins: tuple, omega: torch.Tensor,
                                   sample_offset: int = 0):
    """y[r, c, k] = sum_p x[r, c, p] exp(-i omega[r] (sample_offset + p))
    W[p, bins[k]] from planes xr, xi float[R, C, n] (read in place) and
    omega float[R], as (yr, yi) [R, C, k], views of one [R, C, 2k] tensor:
    the plain version (``ops/fft.py``) on a CPU tensor, ``derot_dft`` (which
    refuses what it is not built for) on CUDA; any other device raises."""
    if xr.device.type == "cpu":
        return dft_matmul_select_derot_planar_reference(xr, xi, bins, omega,
                                                        sample_offset)
    if xr.device.type != "cuda":
        raise ValueError("dft_matmul_select_derot_planar runs on cpu or cuda, "
                         f"not {xr.device}")
    return derot_dft(xr, xi, bins, omega, sample_offset)
