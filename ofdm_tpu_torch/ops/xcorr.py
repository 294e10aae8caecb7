"""Frame synchronization by sliding correlation (port of ofdm_tpu/ops/xcorr.py).

c[lag] = sum_j s[lag + j] conj(tpl[j]); a peak at lag k gives the
reference's offset k - 1 (src/receiver.rs:20-25).  Three forms, as in the
JAX package:

- ``sliding_correlation_matmul``: templates of at most 128 taps, every lag at
  once as one matmul of stride-128 frames of 256 samples against a banded
  Toeplitz of the template.  The plain version behind the ``sync_align``
  kernel (kernels/align.py) and the default sync.
- ``sliding_correlation``: ``conv1d`` for any template length (lags from
  -(K-1)), the route of templates over 128 taps.
- ``sliding_correlation_fft``: overlap-save with ``torch.fft``.

``xcorr_fft`` is the MATLAB-convention oracle of src/signals/mod.rs:186-217,
kept for the tests and for parity of the interface.

``compute_dtype=torch.bfloat16`` rounds the operands to bf16 and multiplies
them in f32, as JAX's bf16 sync accumulates in f32
(``preferred_element_type``): a bf16 x bf16 product is exact in f32, so
only the order of the sums differs from JAX.  On CUDA that needs TF32 off,
which ``ops.fft.require_full_fp32`` enforces before any decode.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .fft import device_table, fft, ifft
from .shift import fft_shift
from .stats import idmax

MAX_TAPS = 128


def _template_is_real(tpl: np.ndarray) -> bool:
    return not np.iscomplexobj(tpl) or not np.any(tpl.imag)


def template_key(tpl) -> bytes:
    """Hashable form of a template for the cached Toeplitz builders (widened
    to complex128, which is exact for complex64 input)."""
    return np.asarray(tpl).astype(np.complex128).tobytes()


@lru_cache(maxsize=None)
def _toeplitz_template(key: bytes, dtype_name: str) -> np.ndarray:
    """Packed banded Toeplitz of the conjugated template, W[512, 256]:
    [frames_re | frames_im] @ W = [c_re | c_im] for 128 lags per frame."""
    t = np.frombuffer(key, dtype=np.complex128)
    k = t.shape[0]
    tr = np.zeros((256, 128))
    ti = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
        ti[b:b + k, b] = t.imag
    return np.block([[tr, -ti], [ti, tr]]).astype(dtype_name)


@lru_cache(maxsize=None)
def _toeplitz_template_real(key: bytes, dtype_name: str) -> np.ndarray:
    """Real-template banded Toeplitz Tr[256, 128]: frames_re @ Tr = c_re and
    frames_im @ Tr = c_im, half the MACs of the packed complex form."""
    t = np.frombuffer(key, dtype=np.complex128)
    k = t.shape[0]
    tr = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
    return tr.astype(dtype_name)


SYNC_DTYPES = (None, torch.bfloat16, "fft", "conv")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and widen back: the operand JAX's bf16
    sync feeds its f32-accumulating product."""
    return x.to(torch.bfloat16).to(x.dtype)


def _operand_rounding(compute_dtype):
    """What the matmul and conv forms apply to their operands: nothing for
    None, ``_bf16`` for torch.bfloat16."""
    if compute_dtype is None:
        return lambda x: x
    if compute_dtype is torch.bfloat16:
        return _bf16
    raise ValueError(f"the matmul and conv correlations compute in None or "
                     f"torch.bfloat16, not {compute_dtype!r}")


def check_sync_dtype(compute_dtype) -> None:
    """Raise ValueError unless ``compute_dtype`` is one of SYNC_DTYPES."""
    if not any(compute_dtype is d or compute_dtype == d for d in SYNC_DTYPES):
        raise ValueError(f"unknown sync compute dtype {compute_dtype!r}; "
                         f"expected one of {SYNC_DTYPES}")


def xcorr_fft(a: torch.Tensor, b: torch.Tensor):
    """MATLAB-style linear cross-correlation of two 1-D signals, parity with
    src/signals/mod.rs:186-217: both padded to 2*len(a) - 1,
    IFFT(FFT(a) conj(FFT(b))), fftshifted.

    Returns (idxmax, cross): cross has length 2*len(a) - 1 and index p is
    lag p - (len(a) - 1); idxmax is the first index of its largest power (a
    0-d tensor on the inputs' device).
    """
    pad_to = 2 * a.shape[-1] - 1
    ap = torch.cat([a, a.new_zeros(pad_to - a.shape[-1])])
    bp = torch.cat([b, b.new_zeros(pad_to - b.shape[-1])])
    cross = fft_shift(ifft(fft(ap, use_matmul=False)
                           * fft(bp, use_matmul=False).conj(),
                           use_matmul=False))
    return idmax(cross), cross


def sliding_correlation_matmul(samples: torch.Tensor, template,
                               compute_dtype=None) -> torch.Tensor:
    """c[lag] = sum_j samples[lag+j] * conj(template[j]) for lag in [0, T-1]
    (samples past T read as zero).  samples: complex[B, T] or [T].
    ``compute_dtype``: None (full precision) or torch.bfloat16."""
    squeeze = samples.dim() == 1
    if squeeze:
        samples = samples[None, :]
    b, t = samples.shape
    tpl = np.asarray(template)
    rnd = _operand_rounding(compute_dtype)
    if tpl.shape[-1] > MAX_TAPS:
        raise NotImplementedError(
            f"matmul correlation supports templates up to {MAX_TAPS} taps")
    rd = torch.float64 if samples.dtype == torch.complex128 else torch.float32
    name = "float64" if rd == torch.float64 else "float32"
    key = template_key(tpl)

    n_frames = -(-t // 128)
    pad = n_frames * 128 + 256 - t
    x = torch.view_as_real(samples)                          # [b, t, 2]
    x = rnd(torch.cat([x, x.new_zeros((b, pad, 2))], dim=1))
    blocks_re = x[..., 0].reshape(b, -1, 128)
    blocks_im = x[..., 1].reshape(b, -1, 128)
    if _template_is_real(tpl):
        w = rnd(device_table(_toeplitz_template_real, (key, name), rd,
                             samples.device))
        frames = torch.cat([
            torch.stack([blocks_re[:, :-1], blocks_im[:, :-1]], dim=1),
            torch.stack([blocks_re[:, 1:], blocks_im[:, 1:]], dim=1),
        ], dim=-1)[:, :, :n_frames]                          # [b, 2, nf, 256]
        out = frames @ w
        c = torch.complex(out[:, 0].reshape(b, -1)[:, :t],
                          out[:, 1].reshape(b, -1)[:, :t])
        return c[0] if squeeze else c
    w = rnd(device_table(_toeplitz_template, (key, name), rd, samples.device))
    frames = torch.cat([blocks_re[:, :-1], blocks_re[:, 1:],
                        blocks_im[:, :-1], blocks_im[:, 1:]],
                       dim=-1)[:, :n_frames]
    out = frames @ w
    c = torch.complex(out[..., :128].reshape(b, -1)[:, :t],
                      out[..., 128:].reshape(b, -1)[:, :t])
    return c[0] if squeeze else c


@lru_cache(maxsize=None)
def _conv_weights(key: bytes, dtype_name: str) -> np.ndarray:
    """conv1d weights of the conjugated template: [2, 1, K] for the grouped
    real form (re and im each against tr), else [2, 2, K] for
    re = sr*tr + si*ti, im = si*tr - sr*ti."""
    t = np.frombuffer(key, dtype=np.complex128)
    tr, ti = t.real, t.imag
    if not np.any(ti):
        return np.stack([tr, tr])[:, None].astype(dtype_name)
    return np.stack([np.stack([tr, ti]), np.stack([-ti, tr])]).astype(dtype_name)


def sliding_correlation(samples: torch.Tensor, template,
                        compute_dtype=None) -> torch.Tensor:
    """c[i] = sum_n samples[i - K + 1 + n] * conj(template[n]) for lags
    i - (K-1) in [-(K-1), T-1]: output index i is lag i - (K-1).

    One ``conv1d`` with padding K-1 on both sides (torch's conv, like XLA's,
    cross-correlates: the kernel is not reversed).  A real template takes the
    grouped form, re and im each against tr alone (half the MACs).
    samples: complex[B, T] or [T], any template length.
    """
    squeeze = samples.dim() == 1
    if squeeze:
        samples = samples[None, :]
    rnd = _operand_rounding(compute_dtype)
    tpl = np.asarray(template)
    k = tpl.shape[-1]
    rd = torch.float64 if samples.dtype == torch.complex128 else torch.float32
    name = "float64" if rd == torch.float64 else "float32"
    w = device_table(_conv_weights, (template_key(tpl), name), rd,
                     samples.device)
    lhs = rnd(torch.stack([samples.real.to(rd), samples.imag.to(rd)], dim=1))
    out = torch.nn.functional.conv1d(lhs, rnd(w), padding=k - 1,
                                     groups=2 if w.shape[1] == 1 else 1)
    c = torch.complex(out[:, 0], out[:, 1])
    return c[0] if squeeze else c


@lru_cache(maxsize=None)
def _padded_template(key: bytes, fft_len: int) -> np.ndarray:
    t = np.frombuffer(key, dtype=np.complex128)
    return np.concatenate([t, np.zeros(fft_len - t.shape[0])])


def sliding_correlation_fft(samples: torch.Tensor, template,
                            fft_len: int = 4096) -> torch.Tensor:
    """Overlap-save sliding correlation: ``sliding_correlation``'s lags >= 0
    (index i = lag i) from batched segment FFTs of ``fft_len`` points.
    samples: complex[B, T] or [T] -> complex[B, T] (windows past the end
    read zeros)."""
    squeeze = samples.dim() == 1
    if squeeze:
        samples = samples[None, :]
    b, t = samples.shape
    tpl = np.asarray(template)
    k = tpl.shape[-1]
    step = fft_len - k + 1
    n_seg = -(-t // step)
    pad_to = n_seg * step + k - 1
    x = torch.cat([samples, samples.new_zeros((b, pad_to - t))], dim=-1)
    idx = (torch.arange(n_seg, device=x.device) * step)[:, None] \
        + torch.arange(fft_len, device=x.device)[None, :]
    segs = x[:, idx]                                    # [B, n_seg, fft_len]
    tpl_pad = device_table(_padded_template, (template_key(tpl), fft_len),
                           samples.dtype, x.device)
    c = torch.fft.ifft(torch.fft.fft(segs, dim=-1) * torch.fft.fft(tpl_pad).conj(),
                       dim=-1)
    c = c[:, :, :step].reshape(b, n_seg * step)[:, :t]
    return c[0] if squeeze else c


def window_energy(samples: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """E[L] = sum_{j<k} |samples[L + j]|^2 for lags L in [0, n), samples
    past the end read as 0; batched over leading axes, in the samples' real
    dtype.

    The running sum behind the differences is float64.  In float32 (the
    JAX package's) it stops growing in a quiet stretch that follows a loud
    one, once each sample adds less than half an ulp: a gap of receiver
    noise after a frame body reads E = 0 exactly, and every normalized
    matched filter over it reads |c|^2 / 1e-30, a false peak that beats
    the true locking block (fault F8 in ROADMAP.md).
    """
    en = samples.real ** 2 + samples.imag ** 2
    cs = torch.nn.functional.pad(
        torch.cumsum(en.double(), dim=-1),
        (1, max(0, n + k - 1 - samples.shape[-1])))
    return (cs[..., k:k + n] - cs[..., :n]).to(en.dtype)


def locking_sync_quality(samples: torch.Tensor, template, compute_dtype=None):
    """(offset, rho) for frame detection in continuous scanning.

    ``rho`` is the normalized matched filter maximized over lags >= 0:
    rho[L] = |c[L]|^2 / (E_template * E_window[L]), in [0, 1] by
    Cauchy-Schwarz, ~snr/(1+snr) at a true locking block and ~ln(T)/K on
    noise-only or data-only lags: the statistic every streaming detection
    gate shares.  The offset comes from the correlation-power argmax, minus
    1, like every sync path (windows past the end read zeros).  Batched
    over leading axes; offset int64, rho in the samples' real dtype.
    """
    c = sliding_correlation(samples, template, compute_dtype=compute_dtype)
    k = np.shape(template)[-1]
    t = samples.shape[-1]
    power = (c.real ** 2 + c.imag ** 2)[..., k - 1:]          # lags 0..T-1
    e_t = float(np.sum(np.abs(np.asarray(template)) ** 2))
    rho = power / (e_t * window_energy(samples, k, t) + 1e-30)
    return torch.argmax(power, dim=-1) - 1, rho.amax(dim=-1)


def locking_sync_offset(samples: torch.Tensor, template,
                        compute_dtype=None) -> torch.Tensor:
    """Frame-sync offset with reference semantics: the first-occurrence
    argmax of the correlation power, minus 1.  Batched over leading axes;
    int64.

    ``compute_dtype`` picks the correlation as ofdm_tpu/ops/xcorr.py does:
    None the matmul form (the conv form over 128 taps), torch.bfloat16 the
    matmul form on bf16 operands (the conv form over 128 taps), "fft"
    overlap-save, "conv" the conv form in full precision.  The conv form
    starts at lag -(K-1), so its offset is argmax - (K-1) - 1.
    """
    check_sync_dtype(compute_dtype)
    k = np.shape(template)[-1]
    if compute_dtype == "fft":
        c = sliding_correlation_fft(samples, template)
    elif compute_dtype == "conv" or k > MAX_TAPS:
        c = sliding_correlation(samples, template,
                                compute_dtype=None if compute_dtype == "conv"
                                else compute_dtype)
        power = c.real ** 2 + c.imag ** 2
        return torch.argmax(power, dim=-1) - (k - 1) - 1
    else:
        c = sliding_correlation_matmul(samples, template,
                                       compute_dtype=compute_dtype)
    power = c.real ** 2 + c.imag ** 2
    return torch.argmax(power, dim=-1) - 1
