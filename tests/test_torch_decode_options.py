"""decode_frame's selectors and the unfused route, against ofdm_tpu on the
same received samples (made by the JAX package's encoder and channel).

The unfused route syncs in plain torch (matmul, bf16, overlap-save FFT or
conv correlation) and copies the windows with the ``planar_align`` kernel
(its plain version here, held bitwise against the Pallas kernel in
interpret mode).  Offsets are compared exactly; correlations to f32 (and
bf16) rounding, since both frameworks sum in their own order; bytes
exactly, at SNRs where every row decodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu.config import DEFAULT_CONFIG as JCFG
from ofdm_tpu.kernels.align_pallas import pin_rowmajor as jax_pin_rowmajor
from ofdm_tpu.kernels.align_pallas import planar_align as jax_planar_align
from ofdm_tpu.ops import xcorr as jxcorr
from ofdm_tpu.phy import rx as jrx
from ofdm_tpu_torch import DEFAULT_CONFIG, constants, convert
from ofdm_tpu_torch.kernels.align import (pin_rowmajor, pin_rowmajor_reference,
                                          planar_align, planar_align_reference)
from ofdm_tpu_torch.ops import xcorr

torch.set_num_threads(1)

QPSK = (ot.Modulation.QPSK, ott.Modulation.QPSK)
SYNC_DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fft": ("fft", "fft"),
               "conv": ("conv", "conv")}


def _rx(n_rows, payload, mod, gb, snr, key, timing=True, seed=0):
    data = np.random.default_rng(seed).integers(0, 256, (n_rows, payload),
                                                dtype=np.uint8)
    tx = ot.encode(data, guard_bands=gb, modulation=mod, dtype=jnp.complex64)
    rx = ot.channel(tx, snr=snr, timing_error=timing, key=jax.random.key(key))
    return data, np.asarray(rx).astype(np.complex64), \
        ot.n_data_blocks(payload, mod, gb)


@pytest.fixture(scope="module")
def setup():
    """tests/test_decode_options.py's batch: 4 rows x 120 B QPSK, SNR 30, CFO."""
    return _rx(4, 120, ot.Modulation.QPSK, True, 30.0, key=1)


def _both(rx, nb, mods=QPSK, gb=True, **kw):
    """(ofdm_tpu bytes, port bytes) of decode_frame on the same rows; each
    keyword is a (JAX value, port value) pair."""
    want = ot.decode_frame(jnp.asarray(rx), n_blocks=nb, guard_bands=gb,
                           modulation=mods[0], **{k: v[0] for k, v in kw.items()})
    got = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb, guard_bands=gb,
                           modulation=mods[1], **{k: v[1] for k, v in kw.items()})
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", list(SYNC_DTYPES))
def test_sync_dtype_offsets_match_jax(setup, name):
    _, rx, _ = setup
    jd, td = SYNC_DTYPES[name]
    want = np.asarray(jrx.sync_offset(jnp.asarray(rx), JCFG, compute_dtype=jd))
    got = ott.sync_offset(torch.as_tensor(rx), compute_dtype=td).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SYNC_DTYPES))
def test_sync_dtype_decode_matches_jax(setup, name):
    data, rx, nb = setup
    want, got = _both(rx, nb, sync_dtype=SYNC_DTYPES[name])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 16:136], data)


@pytest.mark.parametrize("align_impl", ["auto", "xla", "chunked"])
def test_search_window_matches_jax(setup, align_impl):
    """A 256-sample window finds the frame (delay ~9 samples) on every route;
    600 samples later a 1,024-sample window still does."""
    data, rx, nb = setup
    want, got = _both(rx, nb, search_window=(256, 256),
                      align_impl=("auto", align_impl))
    np.testing.assert_array_equal(got, want)
    delayed = np.concatenate([np.zeros((rx.shape[0], 600), rx.dtype), rx], -1)
    want, got = _both(delayed, nb, search_window=(1024, 1024),
                      align_impl=("auto", align_impl))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 16:136], data)
    missed = ott.decode_frame(torch.as_tensor(delayed), n_blocks=nb,
                              guard_bands=True, modulation=ott.Modulation.QPSK,
                              search_window=256, align_impl=align_impl).numpy()
    assert (missed[:, 16:136] != data).any()


@pytest.mark.parametrize("mod", [ot.Modulation.QAM64, ot.Modulation.QAM256],
                         ids=lambda m: m.value)
def test_stream_and_matrix_derot_match_jax(mod):
    """Both derotations, fused and unfused, with the channel's CFO, SNR 55,
    against ofdm_tpu's stream derotation (its matrix derotation, the
    default, meets the port's in test_torch_rx.py)."""
    data, rx, nb = _rx(4, 240, mod, True, 55.0, key=5, seed=7)
    mods = (mod, convert.modulation_from_reference(mod))
    want, _ = _both(rx, nb, mods, derot_impl=("stream", "stream"))
    for derot in ("stream", "matrix"):
        got = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb, guard_bands=True,
                               modulation=mods[1], derot_impl=derot).numpy()
        np.testing.assert_array_equal(got, want, err_msg=derot)
        np.testing.assert_array_equal(got[:, 16:256], data, err_msg=derot)
        unfused = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb,
                                   guard_bands=True, modulation=mods[1],
                                   align_impl="pallas", derot_impl=derot)
        np.testing.assert_array_equal(unfused.numpy(), got, err_msg=derot)


@pytest.fixture(scope="module")
def aligned():
    """tests/test_decode_options.py::test_derot_matrix_diag_parity's rows,
    with the channel's CFO: 3 x 120 B QPSK, SNR 40, already aligned."""
    data, rx, nb = _rx(3, 120, ot.Modulation.QPSK, True, 40.0, key=2, seed=9)
    n_chunks = DEFAULT_CONFIG.n_sync_chunks + nb
    return data, rx[:, :n_chunks * DEFAULT_CONFIG.sym_len], n_chunks


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("derot", ["stream", "matrix"])
def test_decode_aligned_matches_jax(aligned, derot):
    data, rx, n_chunks = aligned
    kw = dict(n_chunks=n_chunks, guard_bands=True, cfo_estimator="coherent",
              derot_impl=derot)
    want, wd = jrx.decode_aligned(jnp.asarray(rx), modulation=QPSK[0], **kw)
    got, gd = ott.decode_aligned(torch.as_tensor(rx), modulation=QPSK[1], **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, 16:136], data)
    for k in ("f_delta", "h_k"):
        _close(gd[k].numpy(), wd[k], 1e-5, k)
    for k in ("chunk6_pre", "chunk6_post"):
        _close(gd[k].numpy(), wd[k], 2e-4, k)
    assert gd["equalized"] is None
    assert gd["h_k"].shape == (3, DEFAULT_CONFIG.n_fft)


@pytest.mark.parametrize("mod,gb", [(ot.Modulation.QAM64, True),
                                    (ot.Modulation.BPSK, False)],
                         ids=["qam64", "bpsk-nogb"])
def test_decode_planar_matrix_matches_jax(mod, gb):
    data, rx, nb = _rx(3, 240, mod, gb, 45.0, key=6, seed=17)
    n_chunks = DEFAULT_CONFIG.n_sync_chunks + nb
    planes = np.stack([rx.real, rx.imag], axis=-2)
    kw = dict(n_chunks=n_chunks, guard_bands=gb, cfo_estimator="coherent")
    want, wd = jrx.decode_planar_matrix(jnp.asarray(planes), modulation=mod, **kw)
    pmod = convert.modulation_from_reference(mod)
    got, gd = ott.decode_planar_matrix(torch.as_tensor(planes), modulation=pmod,
                                       **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, 16:256], data)
    via_aligned, _ = ott.decode_aligned(torch.as_tensor(rx), modulation=pmod,
                                        derot_impl="matrix", **kw)
    np.testing.assert_array_equal(via_aligned.numpy(), got.numpy())
    _close(gd["f_delta"].numpy(), wd["f_delta"], 1e-5, "f_delta")


def test_decode_matches_jax_qam64_with_cfo():
    """``decode`` takes the stream derotation, as ``ot.decode`` does."""
    data, rx, _ = _rx(1, 300, ot.Modulation.QAM64, True, 40.0, key=11, seed=3)
    want = np.asarray(ot.decode(jnp.asarray(rx[0]), guard_bands=True,
                                modulation=ot.Modulation.QAM64))
    got = ott.decode(torch.as_tensor(rx[0]), guard_bands=True,
                     modulation=ott.Modulation.QAM64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[0])


@pytest.mark.parametrize("kw", [
    dict(align_impl="bogus"), dict(derot_impl="bogus"),
    dict(sync_dtype="bogus"), dict(sync_dtype=torch.float16),
    dict(sync_dtype=torch.bfloat16, align_impl="fused"),
    dict(sync_dtype="fft", align_impl="chunked"),
    dict(align_impl="chunked", derot_impl="stream"),
], ids=["align", "derot", "sync-str", "sync-f16", "bf16-fused", "fft-chunked",
        "chunked-stream"])
def test_unknown_or_impossible_selector_raises(setup, kw):
    _, rx, nb = setup
    with pytest.raises(ValueError):
        ott.decode_frame(torch.as_tensor(rx), n_blocks=nb, guard_bands=True,
                         modulation=ott.Modulation.QPSK, **kw)
    with pytest.raises(ValueError):
        planes = torch.stack([torch.as_tensor(rx).real,
                              torch.as_tensor(rx).imag], dim=1)
        ott.decode_frame_planar(planes, n_blocks=nb, guard_bands=True,
                                modulation=ott.Modulation.QPSK, **kw)


def test_decode_aligned_rejects_unknown_derot(aligned):
    _, rx, n_chunks = aligned
    with pytest.raises(ValueError):
        ott.decode_aligned(torch.as_tensor(rx), n_chunks=n_chunks,
                           derot_impl="bogus")


# ---- the correlations of the unfused route -------------------------------

DELAYS = (5, 700, 1999)


def _sync_stream(tpl, t=3000, seed=2):
    rng = np.random.default_rng(seed)
    s = 0.05 * (rng.standard_normal((len(DELAYS), t))
                + 1j * rng.standard_normal((len(DELAYS), t)))
    for i, d in enumerate(DELAYS):
        s[i, d:d + len(tpl)] += tpl
    return s.astype(np.complex64)


TEMPLATES = {
    "ramp80": constants.locking_for(DEFAULT_CONFIG).astype(np.complex64),
    "prn160": constants.locking_for(ott.FrameConfig(
        n_fft=128, cp_len=32, locking_seed=7)).astype(np.complex64),
}


@pytest.mark.parametrize("tpl_name", list(TEMPLATES))
@pytest.mark.parametrize("form", ["conv", "conv-bf16", "fft"])
def test_correlation_forms_match_jax(tpl_name, form):
    tpl = TEMPLATES[tpl_name]
    s = _sync_stream(tpl)
    if form == "fft":
        want = jxcorr.sliding_correlation_fft(jnp.asarray(s), jnp.asarray(tpl))
        got = xcorr.sliding_correlation_fft(torch.as_tensor(s), tpl)
        rtol = 1e-5
    else:
        bf = form == "conv-bf16"
        want = jxcorr.sliding_correlation(
            jnp.asarray(s), jnp.asarray(tpl),
            compute_dtype=jnp.bfloat16 if bf else None)
        got = xcorr.sliding_correlation(
            torch.as_tensor(s), tpl, compute_dtype=torch.bfloat16 if bf else None)
        rtol = 1e-5
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want, rtol, form)
    mode = {"conv": "conv", "conv-bf16": torch.bfloat16, "fft": "fft"}[form]
    np.testing.assert_array_equal(       # the planted templates, argmax - 1
        xcorr.locking_sync_offset(torch.as_tensor(s), tpl,
                                  compute_dtype=mode).numpy(),
        np.asarray(DELAYS) - 1)


def test_bf16_matmul_correlation_matches_jax():
    """bf16 operands, f32 sums: the Toeplitz table rounds to JAX's bitwise,
    and the correlation agrees to f32 rounding."""
    tpl = TEMPLATES["ramp80"]
    jxcorr._TEMPLATE_STORE[(tpl.tobytes(), 80)] = tpl
    jw = np.asarray(jxcorr._toeplitz_template_real((tpl.tobytes(), 80), 80,
                                                   "bfloat16"), np.float32)
    pw = xcorr._bf16(torch.as_tensor(xcorr._toeplitz_template_real(
        xcorr.template_key(tpl), "float32"))).numpy()
    np.testing.assert_array_equal(pw, jw)
    s = _sync_stream(tpl)
    want = jxcorr.sliding_correlation_matmul(jnp.asarray(s), tpl,
                                             compute_dtype=jnp.bfloat16)
    got = xcorr.sliding_correlation_matmul(torch.as_tensor(s), tpl,
                                           compute_dtype=torch.bfloat16)
    _close(got.numpy(), want, 1e-5, "bf16 matmul")


@pytest.mark.parametrize("n,gb", [(64, True), (64, False), (256, False)])
def test_dft_select_and_fft_match_jax(n, gb):
    """The DFTs of the stream-derot front half: at the selected bins, and the
    full transform (ofdm_tpu's ``fft`` is its matmul DFT up to 256 points)."""
    from ofdm_tpu.ops import fft as jfft
    from ofdm_tpu_torch.ops import fft as tfft
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, 5, n))
         + 1j * rng.standard_normal((3, 5, n))).astype(np.complex64)
    cfg = ott.FrameConfig(n_fft=n)
    sel = tuple(range(n)) if not gb else (
        tuple(int(i) for i in cfg.data_indices) + tuple(cfg.pilot_indices))
    _close(tfft.dft_matmul_select(torch.as_tensor(x), sel).numpy(),
           jfft.dft_matmul_select(jnp.asarray(x), sel), 1e-5, "select")
    _close(tfft.dft_matmul(torch.as_tensor(x)).numpy(), jfft.fft(jnp.asarray(x)),
           1e-5, "fft")


# ---- kernels 3 and 5: plain versions against the Pallas kernels ----------

OFFSETS = [0, 1, 79, 80, 127, 128, 129, 255]
NEED = 2400
T_ALIGN = NEED + 300


@pytest.fixture(scope="module")
def align_case():
    """Rows of noise with offsets at lane and tile edges, and T - need; the
    Pallas planar_align's windows (interpret mode)."""
    rng = np.random.default_rng(4)
    s = (rng.standard_normal((9, T_ALIGN))
         + 1j * rng.standard_normal((9, T_ALIGN))).astype(np.complex64)
    offs = np.asarray(OFFSETS + [T_ALIGN - NEED], np.int32)
    want = np.asarray(jax_planar_align(jnp.asarray(s), jnp.asarray(offs), NEED,
                                       interpret=True))
    return s, offs, want


@pytest.mark.parametrize("planar_in", [False, True])
@pytest.mark.parametrize("planar", [False, True])
def test_planar_align_reference_matches_pallas(align_case, planar_in, planar):
    s, offs, want = align_case
    x = torch.as_tensor(s)
    if planar_in:
        x = torch.stack([x.real, x.imag], dim=1).contiguous()
    got = planar_align_reference(x, torch.as_tensor(offs), NEED, planar=planar)
    if planar:
        got = torch.complex(got[:, 0], got[:, 1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_planar_align_on_cpu_runs_the_plain_version(align_case):
    s, offs, want = align_case
    before = planar_align.launches
    got = planar_align(torch.as_tensor(s), torch.as_tensor(offs), NEED)
    np.testing.assert_array_equal(got.numpy(), want)
    assert planar_align.launches == before


@pytest.mark.parametrize("bad", [-1, T_ALIGN - NEED + 1])
def test_planar_align_reference_rejects_unclipped_offsets(align_case, bad):
    s, offs, _ = align_case
    offs = offs.copy()
    offs[2] = bad
    with pytest.raises(ValueError, match="offsets must lie"):
        planar_align(torch.as_tensor(s), torch.as_tensor(offs), NEED)


@pytest.mark.parametrize("view", ["4d", "planes-of-complex", "2d-transposed"])
def test_pin_rowmajor_reference_matches_pallas(view):
    rng = np.random.default_rng(31)
    if view == "4d":      # tests/test_kernels.py::test_pin_rowmajor_identity
        x = torch.as_tensor(rng.standard_normal((5, 2, 7, 128)).astype(np.float32))
    elif view == "planes-of-complex":
        rx = torch.as_tensor((rng.standard_normal((3, 500))
                              + 1j * rng.standard_normal((3, 500))).astype(np.complex64))
        x = torch.view_as_real(rx).transpose(1, 2)         # [3, 2, 500], strided
    else:
        x = torch.as_tensor(rng.standard_normal((300, 6)).astype(np.float32)).t()
    want = np.asarray(jax_pin_rowmajor(jnp.asarray(x.numpy()), interpret=True))
    before = pin_rowmajor.launches
    got = pin_rowmajor(x)
    assert pin_rowmajor.launches == before
    assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pin_rowmajor_reference(x).numpy(), want)


def test_decode_frame_planar_on_a_strided_view(setup):
    """The planes of a complex capture, as a strided view: decoded as the
    contiguous planes are."""
    data, rx, nb = setup
    x = torch.as_tensor(rx)
    view = torch.view_as_real(x).transpose(1, 2)
    assert not view.is_contiguous()
    kw = dict(n_blocks=nb, guard_bands=True, modulation=ott.Modulation.QPSK)
    got = ott.decode_frame_planar(view, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  ott.decode_frame(x, **kw).numpy())
    np.testing.assert_array_equal(got.numpy()[:, 16:136], data)

