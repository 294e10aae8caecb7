"""The small ops / core / obs modules of the port against ofdm_tpu's: the
same numpy inputs, made from a seed, through both packages.

Tolerances: complex128 inputs agree to 1e-9 (different FFT libraries and
summation orders), complex64 to 1e-4 relative; bit and byte results, the
copied modules and the oracles pasted from the reference are exact.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_tpu import constants
from ofdm_tpu.core import bitops as jbitops
from ofdm_tpu.obs import analysis as janalysis
from ofdm_tpu.obs import ber_theory as jber
from ofdm_tpu.obs import plots as jplots
from ofdm_tpu.ops import convolve as jconvolve
from ofdm_tpu.ops import fft as jfft
from ofdm_tpu.ops import shift as jshift
from ofdm_tpu.ops import stats as jstats
from ofdm_tpu.ops import xcorr as jxcorr
from ofdm_tpu.phy import modulation as jmod
from ofdm_tpu.phy import tx as jtx
from ofdm_tpu_torch import convert
from ofdm_tpu_torch.core import bitops
from ofdm_tpu_torch.obs import analysis, ber_theory, plots, taps
from ofdm_tpu_torch.ops import convolve, fft, shift, stats, xcorr
from ofdm_tpu_torch.phy import modulation, tx

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# --- copies -------------------------------------------------------------------

@pytest.mark.parametrize("module", ["obs/taps.py", "obs/plots.py",
                                    "obs/ber_theory.py"])
def test_copies_are_byte_equal(module):
    assert (ROOT / "ofdm_tpu_torch" / module).read_bytes() == \
        (ROOT / "ofdm_tpu" / module).read_bytes()


def test_ber_theory_uses_the_ports_modulation():
    assert ber_theory.Modulation is modulation.Modulation
    for mod in jmod.Modulation:
        port = convert.modulation_from_reference(mod)
        assert ber_theory.ber_awgn(port, 12.0) == jber.ber_awgn(mod, 12.0)
        assert ber_theory.symbol_energy(port) == jber.symbol_energy(mod)


def test_plots_render_the_same(rng):
    sig = _cplx(rng, 200)
    assert plots.stem_plot(sig, smooth=True) == jplots.stem_plot(sig, smooth=True)
    assert plots.constellation(sig) == jplots.constellation(sig)


def test_taps_write_reals_and_imag(tmp_path, rng):
    sig = _cplx(rng, 16)
    assert not taps.enabled()
    taps.tap("nothing", sig)                       # a no-op while disabled
    taps.enable(tmp_path)
    try:
        taps.tap("sig", sig)
    finally:
        taps.disable()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["sig_imag.npy", "sig_reals.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "sig_reals.npy"), sig.real)
    np.testing.assert_array_equal(np.load(tmp_path / "sig_imag.npy"), sig.imag)


def test_debug_data_and_trim_to_match(rng):
    a = rng.integers(0, 256, 40, dtype=np.uint8)
    b = a.copy()
    b[[3, 17]] ^= 0x41
    assert analysis.debug_data(a, b) == janalysis.debug_data(a, b)
    assert analysis.debug_data(a, b[:30], limit=12) == \
        janalysis.debug_data(a, b[:30], limit=12)
    np.testing.assert_array_equal(analysis.trim_to(b, 25), janalysis.trim_to(b, 25))
    assert dataclasses.astuple(analysis.Analysis.new(a, b)) == \
        dataclasses.astuple(janalysis.Analysis.new(a, b))


# --- bitops -------------------------------------------------------------------

def test_bitops_match_jax_and_round_trip(rng):
    data = rng.integers(0, 256, (3, 50), dtype=np.uint8)
    bits = bitops.bytes_to_bits(torch.as_tensor(data))
    assert bits.dtype == torch.bool and tuple(bits.shape) == (3, 400)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jbitops.bytes_to_bits(jnp.asarray(data))))
    back = bitops.bits_to_bytes(bits)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbitops.bits_to_bytes(jnp.asarray(bits.numpy()))))
    # LSB first: 0b00000110 -> bits 1 and 2
    assert bitops.bytes_to_bits(torch.tensor([6], dtype=torch.uint8)).tolist() == \
        [False, True, True, False, False, False, False, False]
    # a trailing partial byte is dropped, as in the JAX package
    np.testing.assert_array_equal(
        bitops.bits_to_bytes(bits[:, :397]).numpy(),
        np.asarray(jbitops.bits_to_bytes(jnp.asarray(bits.numpy()[:, :397]))))


def test_np_bitops_match(rng):
    data = rng.integers(0, 256, 33, dtype=np.uint8)
    bits = bitops.np_bytes_to_bits(data)
    np.testing.assert_array_equal(bits, jbitops.np_bytes_to_bits(data))
    np.testing.assert_array_equal(bitops.np_bits_to_bytes(bits), data)
    np.testing.assert_array_equal(bitops.np_bits_to_bytes(bits),
                                  jbitops.np_bits_to_bytes(bits))


# --- shift, stats -------------------------------------------------------------

class TestShift:
    @pytest.mark.parametrize("n", [6, 7, 64, 80])
    def test_matches_numpy(self, n, rng):
        x = _cplx(rng, n)
        got = shift.fft_shift(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.fft.fftshift(x))
        np.testing.assert_array_equal(got, np.asarray(jshift.fft_shift(jnp.asarray(x))))
        np.testing.assert_array_equal(
            shift.ifft_shift(torch.as_tensor(x)).numpy(), np.fft.ifftshift(x))

    def test_roundtrip_odd(self, rng):
        x = rng.standard_normal(7)
        back = shift.ifft_shift(shift.fft_shift(torch.as_tensor(x))).numpy()
        np.testing.assert_array_equal(back, x)

    def test_axis(self, rng):
        x = _cplx(rng, 5, 6)
        np.testing.assert_array_equal(
            shift.fft_shift(torch.as_tensor(x), axis=0).numpy(),
            np.asarray(jshift.fft_shift(jnp.asarray(x), axis=0)))


class TestStats:
    VALS = [1 + 1j, 1 + 2j, 1 + 3j]

    def test_mean(self):
        # mean_works oracle (src/signals/mod.rs:386-394)
        vals = torch.tensor(self.VALS)
        assert complex(stats.mean(vals)) == 1 + 2j
        assert complex(stats.mean(vals)) == complex(jstats.mean(jnp.asarray(self.VALS)))

    def test_variance_pseudo(self):
        vals = torch.tensor(self.VALS, dtype=torch.complex128)
        assert np.isclose(complex(stats.variance(vals)), -2.0 / 3.0)
        assert np.isclose(complex(stats.variance(vals)),
                          complex(jstats.variance(jnp.asarray(self.VALS))))

    def test_idmax_first_occurrence(self):
        vals = [1 + 0j, 3 + 0j, 0 + 3j, 1 + 0j]
        assert int(stats.idmax(torch.tensor(vals))) == 1
        assert int(jstats.idmax(jnp.asarray(vals))) == 1

    def test_batched(self, rng):
        x = _cplx(rng, 4, 33)
        t = torch.as_tensor(x)
        np.testing.assert_allclose(stats.mean(t).numpy(),
                                   np.asarray(jstats.mean(jnp.asarray(x))), atol=1e-12)
        np.testing.assert_allclose(stats.variance(t).numpy(),
                                   np.asarray(jstats.variance(jnp.asarray(x))),
                                   atol=1e-12)
        np.testing.assert_array_equal(stats.idmax(t).numpy(),
                                      np.asarray(jstats.idmax(jnp.asarray(x))))


# --- fft ----------------------------------------------------------------------

class TestFFT:
    def test_ifft_is_1_over_n_normalized(self):
        x = np.zeros(64, dtype=np.complex128)
        x[0] = 64.0
        out = fft.ifft(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(out, np.ones(64), atol=1e-12)

    @pytest.mark.parametrize("n", [64, 80, 1000])
    def test_roundtrip(self, n, rng):
        x = _cplx(rng, 4, n)
        back = fft.ifft(fft.fft(torch.as_tensor(x))).numpy()
        np.testing.assert_allclose(back, x, atol=1e-9)

    @pytest.mark.parametrize("n,use_matmul", [(64, None), (256, None),
                                              (300, None), (64, False),
                                              (300, True)])
    def test_fft_ifft_match_jax(self, n, use_matmul, rng):
        """Matmul form up to 256 points, the library FFT above, as JAX's."""
        x = _cplx(rng, 2, n)
        for mine, theirs in ((fft.fft, jfft.fft), (fft.ifft, jfft.ifft)):
            np.testing.assert_allclose(
                mine(torch.as_tensor(x), use_matmul=use_matmul).numpy(),
                np.asarray(theirs(jnp.asarray(x), use_matmul=use_matmul)),
                atol=1e-9)
        assert fft._should_use_matmul(torch.as_tensor(x), use_matmul) == \
            jfft._should_use_matmul(jnp.asarray(x), use_matmul)

    @pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-9),
                                           (np.complex64, 1e-4)])
    def test_dft_matmul_select_derot_matches_jax(self, dtype, tol, rng):
        bins = tuple(range(1, 27)) + tuple(range(38, 64))
        x = _cplx(rng, 3, 5, 64).astype(dtype)
        omega = (0.03 * rng.random(3)).astype(np.float64 if dtype is np.complex128
                                              else np.float32)
        want = np.asarray(jfft.dft_matmul_select_derot(
            jnp.asarray(x), bins, jnp.asarray(omega), sample_offset=16))
        got = fft.dft_matmul_select_derot(torch.as_tensor(x), bins,
                                          torch.as_tensor(omega),
                                          sample_offset=16).numpy()
        assert got.shape == want.shape == (3, 5, 52) and got.dtype == dtype
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())
        # the derotate-then-DFT oracle of tests/test_ops.py
        p = np.arange(64) + 16
        derot = x * np.exp(-1j * omega[:, None, None] * p)
        oracle = np.fft.fft(derot, axis=-1)[..., list(bins)]
        np.testing.assert_allclose(got, oracle, atol=10 * tol * np.abs(oracle).max())

    @pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-12),
                                           (np.complex64, 1e-5)])
    def test_idft_matmul_rows_matches_jax(self, dtype, tol, rng):
        bins = tuple(range(1, 25)) + tuple(range(40, 64))
        x = _cplx(rng, 2, 7, len(bins)).astype(dtype)
        want = np.asarray(jfft.idft_matmul_rows(jnp.asarray(x), bins, 64))
        got = fft.idft_matmul_rows(torch.as_tensor(x), bins, 64).numpy()
        assert got.shape == (2, 7, 64) and got.dtype == dtype
        np.testing.assert_allclose(got, want, atol=tol)
        spec = np.zeros((2, 7, 64), dtype=np.complex128)
        spec[..., list(bins)] = x
        np.testing.assert_allclose(got, np.fft.ifft(spec, axis=-1), atol=10 * tol)


def test_peak_normalize_matches_jax(rng):
    """max of re and im WITHOUT abs (src/transmitter.rs:183-194): a stream
    whose largest magnitude is negative is not normalized by it."""
    x = _cplx(rng, 3, 200)
    x[1] = -np.abs(x[1].real) - 1j * np.abs(x[1].imag) + 0.25
    want = np.asarray(jtx.peak_normalize(jnp.asarray(x)))
    got = tx.peak_normalize(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert np.isclose(max(got[0].real.max(), got[0].imag.max()), 1.0)


# --- xcorr, convolve ----------------------------------------------------------

class TestXcorr:
    def test_xcorr_fft_oracle_small(self):
        # hand-derived oracle of the reference's xcorr_fft on x=[1,2,3],
        # h=[4,5]: circular corr on pad-to-5 = [14,23,12,0,5], shifted
        idx, cross = xcorr.xcorr_fft(
            torch.tensor([1, 2, 3], dtype=torch.complex128),
            torch.tensor([4, 5], dtype=torch.complex128))
        np.testing.assert_allclose(cross.numpy().real, [0, 5, 14, 23, 12],
                                   atol=1e-9)
        assert int(idx) == 3

    def test_xcorr_fft_matches_jax(self, rng):
        a, b = _cplx(rng, 400), _cplx(rng, 80)
        idx, cross = xcorr.xcorr_fft(torch.as_tensor(a), torch.as_tensor(b))
        jidx, jcross = jxcorr.xcorr_fft(jnp.asarray(a), jnp.asarray(b))
        assert cross.shape[0] == 2 * 400 - 1
        np.testing.assert_allclose(cross.numpy(), np.asarray(jcross), atol=1e-9)
        assert int(idx) == int(jidx)

    def test_sliding_matches_xcorr_fft_on_overlap(self, rng):
        n, k = 400, 80
        a, b = _cplx(rng, n), _cplx(rng, k)
        _, cross = xcorr.xcorr_fft(torch.as_tensor(a), torch.as_tensor(b))
        sl = xcorr.sliding_correlation(torch.as_tensor(a), b).numpy()
        # cross index p = lag p-(n-1); sliding index i = lag i-(k-1)
        full = cross.numpy()
        for lag in (-5, 0, 1, 17, n - k, n - 2):
            np.testing.assert_allclose(sl[lag + k - 1], full[lag + n - 1],
                                       atol=1e-6)

    def test_sync_offset_matches_reference_formula(self, rng):
        lock = constants.locking_signal(80)
        for delay in (9, 50, 123):
            stream = np.zeros(1000, dtype=np.complex128)
            stream[delay:delay + 80] = lock
            stream += 0.01 * _cplx(rng, 1000)
            off = int(xcorr.locking_sync_offset(torch.as_tensor(stream), lock))
            idx, cross = xcorr.xcorr_fft(torch.as_tensor(stream),
                                         torch.as_tensor(lock))
            # the reference: idxmax - ((len-1)/2 + 1) == peak_lag - 1
            ref_off = int(idx) - ((cross.shape[0] - 1) // 2 + 1)
            assert off == ref_off == delay - 1


class TestConvolve:
    def test_fft_matches_direct(self, rng):
        x = _cplx(rng, 128)
        h = torch.as_tensor(constants.CHANNEL_TAPS)
        got = convolve.convolve_fft(torch.as_tensor(x), h).numpy()
        np.testing.assert_allclose(
            got, convolve.convolve_direct(torch.as_tensor(x), h).numpy(), atol=1e-8)
        np.testing.assert_allclose(
            got, np.asarray(jconvolve.convolve_fft(
                jnp.asarray(x), jnp.asarray(constants.CHANNEL_TAPS))), atol=1e-9)
        np.testing.assert_allclose(got, np.convolve(x, constants.CHANNEL_TAPS),
                                   atol=1e-9)

    @pytest.mark.parametrize("form", ["direct", "fft"])
    def test_channel_conv_matlab_oracle(self, form):
        # MATLAB oracle pasted in the reference test channel_makes_sense
        # (src/channel.rs:93-178): conv of 128 x (1-1j) with CHANNEL.
        x = torch.as_tensor(np.full(128, 1.0 - 1.0j))
        h = torch.as_tensor(constants.CHANNEL_TAPS)
        fn = convolve.convolve_direct if form == "direct" else convolve.convolve_fft
        out = fn(x, h).numpy()
        expected_re = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -0.0000,
                       -0.1912, 0.7404, 1.0225, 0.8234, 0.9864, 0.8847,
                       0.9391, 0.9130, 0.9220, 0.9220, 0.9186]
        # the pasted MATLAB output is rounded to 4 decimals
        np.testing.assert_allclose(out.real[:19], expected_re, atol=1.5e-4)
        np.testing.assert_allclose(out.imag[:19], -np.asarray(expected_re),
                                   atol=1.5e-4)


# --- the bit-tensor mapper and demapper ---------------------------------------

@pytest.mark.parametrize("mod", list(jmod.Modulation), ids=lambda m: m.value)
def test_modulate_bits_matches_jax(mod, rng):
    port = convert.modulation_from_reference(mod)
    # 253 bits: no multiple of any symbol size but BPSK's, so the last
    # partial symbol is zero-padded
    bits = rng.integers(0, 2, (2, 253)).astype(bool)
    want = np.asarray(jmod.modulate_bits(jnp.asarray(bits), mod))
    got = modulation.modulate_bits(torch.as_tensor(bits), port)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    got128 = modulation.modulate_bits(torch.as_tensor(bits), port,
                                      dtype=torch.complex128)
    assert got128.dtype == torch.complex128
    np.testing.assert_array_equal(got128.numpy(), want.astype(np.complex128))
    # the packed form agrees on whole bytes
    data = rng.integers(0, 256, (2, 30), dtype=np.uint8)
    np.testing.assert_array_equal(
        modulation.modulate_bits(bitops.bytes_to_bits(torch.as_tensor(data)),
                                 port).numpy(),
        modulation.modulate_bytes_packed(torch.as_tensor(data), port).numpy())


@pytest.mark.parametrize("mod", list(jmod.Modulation), ids=lambda m: m.value)
def test_demodulate_symbols_matches_jax(mod, rng):
    port = convert.modulation_from_reference(mod)
    n_levels = 1 << max(1, jmod.BITS_PER_SYMBOL[mod] // 2)
    syms = (_cplx(rng, 3, 96) * n_levels * 0.8).astype(np.complex64)
    # points on the decision boundaries and the axes
    syms[0, :6] = [0, -1, 1j, -1j, 2 + 2j, -2 - 4j]
    want = np.asarray(jmod.demodulate_symbols(jnp.asarray(syms), mod))
    got = modulation.demodulate_symbols(torch.as_tensor(syms), port)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if got.shape[-1] % 8 == 0:
        np.testing.assert_array_equal(
            bitops.bits_to_bytes(got).numpy(),
            modulation.demodulate_symbols_packed(torch.as_tensor(syms), port).numpy())


@pytest.mark.parametrize("mod", list(jmod.Modulation), ids=lambda m: m.value)
def test_bits_round_trip(mod, rng):
    port = convert.modulation_from_reference(mod)
    data = rng.integers(0, 256, 48, dtype=np.uint8)      # 384 bits: whole symbols
    bits = bitops.bytes_to_bits(torch.as_tensor(data))
    back = modulation.demodulate_symbols(modulation.modulate_bits(bits, port), port)
    np.testing.assert_array_equal(bitops.bits_to_bytes(back).numpy(), data)
