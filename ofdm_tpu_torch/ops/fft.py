"""DFT matrices and the matrix-form transforms (port of ofdm_tpu/ops/fft.py).

The per-symbol transforms are 64 points long, so each is a dense fp32 (or
fp64) matrix product.  A complex product (xr + j xi)(Wr + j Wi) is packed as
one real product

    [xr xi] @ [[Wr, Wi], [-Wi, Wr]] = [xr@Wr - xi@Wi,  xr@Wi + xi@Wr]

and left to ``torch.matmul``.  Forward transforms are unnormalized, inverse
ones scaled by 1/N (numpy's convention, as the reference's).  The decode
path's derotated DFT at the selected bins is a hand-written kernel on CUDA
(``kernels/derot.py``); its plain version is here.

On CUDA these products must run in full fp32: ``require_full_fp32`` refuses
to run while TF32 is allowed for matmuls or cuDNN convolutions, and
``set_full_fp32`` turns it off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


_TF32_HELP = (
    "ofdm_tpu_torch needs full-fp32 products on CUDA.  Turn TF32 off in one "
    "way only: call ofdm_tpu_torch.ops.fft.set_full_fp32(), or set "
    "torch.backends.cuda.matmul.fp32_precision = \"ieee\" and "
    "torch.backends.cudnn.conv.fp32_precision = \"ieee\" (or, on a PyTorch "
    "without fp32_precision, torch.backends.cuda.matmul.allow_tf32 = False "
    "and torch.backends.cudnn.allow_tf32 = False)")


def _has_precision_api() -> bool:
    """Whether this PyTorch has the per-operator ``fp32_precision`` settings
    (then the legacy ``allow_tf32`` flags are neither read nor written:
    PyTorch raises on some reads of one after a write of the other)."""
    return hasattr(torch.backends.cuda.matmul, "fp32_precision")


def _resolved_precisions() -> dict:
    """The ``fp32_precision`` in force for cuBLAS matmuls and cuDNN
    convolutions: an operator's "none" takes its backend's value, a
    backend's "none" the global one.  "none" at every level is PyTorch's
    unset state, which runs fp32 products as they are."""
    top = torch.backends.fp32_precision
    cudnn = torch.backends.cudnn
    chains = {"cuda.matmul": (torch.backends.cuda.matmul.fp32_precision, top),
              "cudnn.conv": (cudnn.conv.fp32_precision, cudnn.fp32_precision,
                             top)}
    return {name: next((v for v in chain if v != "none"), "none")
            for name, chain in chains.items()}


def set_full_fp32() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions, through the
    ``fp32_precision`` settings where this PyTorch has them and through the
    legacy ``allow_tf32`` flags only where it does not.  The apps and
    ``chip_smoke.py`` call this, so no process of theirs mixes the two."""
    if _has_precision_api():
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def require_full_fp32(device: torch.device) -> None:
    """Raise if fp32 products on ``device`` may fall to TF32.

    TF32 keeps about three decimal digits: enough to flip QAM256 decisions
    and the channel's convolution.  The package sets no global flag itself;
    the caller turns TF32 off, with ``set_full_fp32()`` or in either of the
    ways the error names (cuDNN convolutions, which ``conv1d`` runs on,
    allow TF32 by default).  Only the flags are read, so the check costs no
    device work.
    """
    if device.type != "cuda":
        return
    if not _has_precision_api():
        if torch.backends.cuda.matmul.allow_tf32 \
                or torch.backends.cudnn.allow_tf32:
            raise RuntimeError(_TF32_HELP)
        return
    try:
        found = _resolved_precisions()
    except RuntimeError as e:       # PyTorch's own refusal of a mixed state
        raise RuntimeError(f"{_TF32_HELP}; PyTorch could not report its "
                           f"precision settings ({e})") from e
    bad = {k: v for k, v in found.items() if v not in ("ieee", "none")}
    if bad:
        raise RuntimeError(f"{_TF32_HELP}; found " + ", ".join(
            f"torch.backends.{k}.fp32_precision = {v!r}"
            for k, v in bad.items()))


@lru_cache(maxsize=None)
def device_table(fn, args: tuple, dtype: torch.dtype, device: torch.device):
    """``fn(*args)`` (a cached numpy table builder, or one returning a tuple
    of tables) as tensors on ``device``, built once per (table, dtype,
    device) so the decode path makes no host-to-device copy of its
    constants."""
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(torch.tensor(a, dtype=dtype, device=device) for a in out)
    return torch.tensor(np.asarray(out), dtype=dtype, device=device)


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for complex128/float64 data, float32 otherwise."""
    return torch.float64 if dtype in (torch.complex128, torch.float64) \
        else torch.float32


@lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        w /= n
    return w


@lru_cache(maxsize=None)
def _packed_dft_matrix(n: int, inverse: bool) -> np.ndarray:
    w = _dft_matrix(n, inverse)
    return np.block([[w.real, w.imag], [-w.imag, w.real]])


def dft_matmul(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """DFT over the last axis as one packed real matmul; matches
    ``torch.fft.fft`` (forward) / ``torch.fft.ifft`` (inverse, 1/N)."""
    n = x.shape[-1]
    w = device_table(_packed_dft_matrix, (n, inverse), real_dtype(x.dtype),
                     x.device)
    out = torch.cat([x.real, x.imag], dim=-1) @ w
    return torch.complex(out[..., :n], out[..., n:])


def fft(x: torch.Tensor, use_matmul: bool | None = None) -> torch.Tensor:
    """Forward DFT on the last axis, unnormalized (the reference's rustfft
    semantics): the matmul form up to 256 points, ``torch.fft`` above,
    unless ``use_matmul`` says which."""
    if _should_use_matmul(x, use_matmul):
        return dft_matmul(x, inverse=False)
    return torch.fft.fft(x, dim=-1)


def ifft(x: torch.Tensor, use_matmul: bool | None = None) -> torch.Tensor:
    """Inverse DFT on the last axis, scaled by 1/N (src/signals/mod.rs:49-58)."""
    if _should_use_matmul(x, use_matmul):
        return dft_matmul(x, inverse=True)
    return torch.fft.ifft(x, dim=-1)


def _should_use_matmul(x: torch.Tensor, use_matmul: bool | None) -> bool:
    if use_matmul is not None:
        return use_matmul
    # the 64-point OFDM symbol is a matmul; long transforms are O(n log n)
    return x.shape[-1] <= 256


@lru_cache(maxsize=None)
def _packed_dft_select_matrix(n: int, bins: tuple) -> np.ndarray:
    w = _dft_matrix(n, inverse=False)[:, list(bins)]
    return np.block([[w.real, w.imag], [-w.imag, w.real]])


def dft_matmul_select_planar(x: torch.Tensor, bins: tuple):
    """Forward DFT over the last axis at ``bins`` only, as planes (yr, yi).

    x: complex[..., n].  One packed [.., 2n] x [2n, 2k] product; yr and yi
    are its two halves, views of one contiguous [..., 2k] tensor (the layout
    ``eq_demod_pack`` reads).  Each output is the same dot product as
    ofdm_tpu's ``dft_matmul_select_planar``.
    """
    n = x.shape[-1]
    k = len(bins)
    w = device_table(_packed_dft_select_matrix, (n, tuple(bins)),
                     real_dtype(x.dtype), x.device)
    out = torch.cat([x.real, x.imag], dim=-1) @ w
    return out[..., :k], out[..., k:]


def dft_matmul_select(x: torch.Tensor, bins: tuple) -> torch.Tensor:
    """Forward DFT over the last axis at ``bins`` only (complex output, in
    the order of ``bins``)."""
    yr, yi = dft_matmul_select_planar(x, bins)
    return torch.complex(yr, yi)


@lru_cache(maxsize=None)
def _dft_select_planes(n: int, bins: tuple, dtype_name: str):
    w = _dft_matrix(n, inverse=False)[:, list(bins)]
    return (np.ascontiguousarray(w.real).astype(dtype_name),
            np.ascontiguousarray(w.imag).astype(dtype_name))


def _derot_select_matrix(n: int, bins: tuple, omega: torch.Tensor,
                         sample_offset: int):
    """Per-row derotated DFT matrix halves (top, bot), each [..., n, 2k],
    such that ``xr @ top + xi @ bot`` is the DFT at ``bins`` of the symbol
    derotated by exp(-i*omega*(sample_offset + p))."""
    name = "float64" if omega.dtype == torch.float64 else "float32"
    wr, wi = device_table(_dft_select_planes, (n, bins, name), omega.dtype,
                          omega.device)
    p_idx = torch.arange(n, dtype=omega.dtype, device=omega.device) \
        + sample_offset
    ang = omega[..., None] * p_idx                         # [..., n]
    cr = torch.cos(ang)[..., :, None]                      # [..., n, 1]
    ci = -torch.sin(ang)[..., :, None]
    vr = cr * wr - ci * wi                                 # [..., n, k]
    vi = cr * wi + ci * wr
    top = torch.cat([vr, vi], dim=-1)                      # [..., n, 2k]
    bot = torch.cat([-vi, vr], dim=-1)
    return top, bot


def check_derot_planar(xr: torch.Tensor, xi: torch.Tensor,
                       omega: torch.Tensor) -> None:
    if xr.dim() != 3 or xr.shape != xi.shape:
        raise ValueError(f"xr and xi must share one [R, C, n] shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if tuple(omega.shape) != (xr.shape[0],):
        raise ValueError(f"omega must hold one value per row, [{xr.shape[0]}],"
                         f" got {tuple(omega.shape)}")
    if not xr.dtype == xi.dtype == omega.dtype \
            or not xr.device == xi.device == omega.device:
        raise ValueError("xr, xi and omega must share dtype and device")


def dft_matmul_select_derot_planar_reference(xr: torch.Tensor,
                                             xi: torch.Tensor, bins: tuple,
                                             omega: torch.Tensor,
                                             sample_offset: int = 0):
    """Plain version of ``dft_matmul_select_derot_planar``: the
    within-symbol phasor folded into a per-row matrix (``top``, ``bot``),
    then ``xr @ top + xi @ bot`` as two batched products."""
    check_derot_planar(xr, xi, omega)
    k = len(bins)
    top, bot = _derot_select_matrix(xr.shape[-1], tuple(bins), omega,
                                    sample_offset)
    out = torch.baddbmm(torch.bmm(xr, top), xi, bot)
    return out[..., :k], out[..., k:]


def dft_matmul_select_derot(x: torch.Tensor, bins: tuple, omega: torch.Tensor,
                            sample_offset: int = 0) -> torch.Tensor:
    """``dft_matmul_select`` of per-row CFO-derotated symbols, complex in and
    out: x complex[..., C, n], omega real[...] (x's batch shape) ->
    complex[..., C, k] with
    y[..., c, k] = sum_p x[..., c, p] exp(-i omega (sample_offset + p)) W[p, bins[k]].
    One packed [.., C, 2n] x [.., 2n, 2k] product per row; the per-chunk
    phase exp(-i omega c sym_len) is left to the caller, as in the planar
    form."""
    k = len(bins)
    top, bot = _derot_select_matrix(x.shape[-1], tuple(bins),
                                    omega.to(real_dtype(x.dtype)),
                                    sample_offset)
    out = torch.cat([x.real, x.imag], dim=-1) @ torch.cat([top, bot], dim=-2)
    return torch.complex(out[..., :k], out[..., k:])


@lru_cache(maxsize=None)
def _packed_idft_rows_matrix(n: int, bins: tuple) -> np.ndarray:
    w = _dft_matrix(n, inverse=True)[list(bins), :]        # [k, n]
    return np.block([[w.real, w.imag], [-w.imag, w.real]])  # [2k, 2n]


@lru_cache(maxsize=None)
def _packed_idft_rows_cp_matrix(n: int, bins: tuple, cp_len: int) -> np.ndarray:
    w = _packed_idft_rows_matrix(n, bins)
    re, im = w[:, :n], w[:, n:]
    re_cp = np.concatenate([re[:, n - cp_len:], re], axis=1)
    im_cp = np.concatenate([im[:, n - cp_len:], im], axis=1)
    return np.ascontiguousarray(np.concatenate([re_cp, im_cp], axis=1))


def idft_matmul_rows(x: torch.Tensor, bins: tuple, n: int) -> torch.Tensor:
    """Inverse DFT (1/N) of a spectrum nonzero only at ``bins``:
    complex[..., k] bin values (in the order of ``bins``) -> complex[..., n]
    samples, one packed [.., 2k] x [2k, 2n] product: the guard bins are
    neither scattered nor multiplied."""
    assert x.shape[-1] == len(bins)
    w = device_table(_packed_idft_rows_matrix, (n, tuple(bins)),
                     real_dtype(x.dtype), x.device)
    out = torch.cat([x.real, x.imag], dim=-1) @ w
    return torch.complex(out[..., :n], out[..., n:])


def idft_matmul_rows_cp(x: torch.Tensor, bins: tuple, n: int,
                        cp_len: int) -> torch.Tensor:
    """Inverse DFT (1/N) of a spectrum nonzero only at ``bins``, with the
    cyclic prefix folded into the matrix: complex[..., k] ->
    complex[..., cp_len + n], the first cp_len samples repeating the tail."""
    assert x.shape[-1] == len(bins)
    w = device_table(_packed_idft_rows_cp_matrix, (n, tuple(bins), cp_len),
                     real_dtype(x.dtype), x.device)
    out = torch.cat([x.real, x.imag], dim=-1) @ w
    m = n + cp_len
    return torch.complex(out[..., :m], out[..., m:])
