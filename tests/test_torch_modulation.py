"""Symbol mapping and hard decisions: the port against ofdm_tpu, exactly, for
all five schemes, including the QPSK exact-zero fallthrough and QAM ties
that round half to even."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu.phy import modulation as jmod
from ofdm_tpu_torch import convert
from ofdm_tpu_torch.phy import modulation as tmod

torch.set_num_threads(1)

SCHEMES = list(ot.Modulation)


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda m: m.value)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 96])
def test_modulate_bytes_packed_matches_jax(scheme, n):
    rng = np.random.default_rng(22 + n)
    data = rng.integers(0, 256, (2, n), dtype=np.uint8)
    port = convert.modulation_from_reference(scheme)
    for jdt, tdt in ((jnp.complex64, torch.complex64),
                     (jnp.complex128, torch.complex128)):
        want = np.asarray(jmod.modulate_bytes_packed(jnp.asarray(data), scheme,
                                                     dtype=jdt))
        got = tmod.modulate_bytes_packed(torch.as_tensor(data), port,
                                         dtype=tdt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda m: m.value)
@pytest.mark.parametrize("n_sym", [4, 7, 12, 33, 128])
def test_demodulate_symbols_packed_matches_jax(scheme, n_sym):
    rng = np.random.default_rng(21 + n_sym)
    re = rng.normal(0, 4, (4, n_sym))
    im = rng.normal(0, 4, (4, n_sym))
    re[0, : n_sym // 2] = 0.0            # QPSK (re<0, im==0) fallthrough edges
    im[1, : n_sym // 2] = 0.0
    re[1, n_sym // 2:] = -1.0
    # exact decision thresholds (even integers): QAM rounds half to even
    ties = np.arange(-18, 18, 2, dtype=np.float64)
    re[2] = np.resize(ties, n_sym)
    im[3] = np.resize(ties[::-1], n_sym)
    syms = (re + 1j * im).astype(np.complex64)
    want = np.asarray(jmod.demodulate_symbols_packed(jnp.asarray(syms), scheme))
    got = tmod.demodulate_symbols_packed(
        torch.as_tensor(syms), convert.modulation_from_reference(scheme)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda m: m.value)
def test_modulate_demodulate_round_trip(scheme):
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.integers(0, 256, (3, 48), dtype=np.uint8))
    port = convert.modulation_from_reference(scheme)
    syms = tmod.modulate_bytes_packed(data, port)
    assert torch.equal(tmod.demodulate_symbols_packed(syms, port), data)
