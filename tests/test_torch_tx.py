"""Transmitter and channel: the port against ofdm_tpu and the golden frames.

The two encoders sum in different orders (XLA's and torch's matmuls), so
frames agree to a rounding tolerance rather than bitwise: 1e-6 in complex64
(samples are O(1)), 1e-12 in complex128.  The torch generator cannot
reproduce jax.random's bits, so the channel is compared at SNR 300 (noise
~1e-15) and its noise is checked statistically.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu_torch import constants, convert
from ofdm_tpu_torch.ops.convolve import convolve_direct

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tx_frames.npz")
SCHEMES = list(ot.Modulation)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda m: m.value)
@pytest.mark.parametrize("gb", [True, False])
def test_encode_matches_jax_complex64(scheme, gb):
    data = np.random.default_rng(3).integers(0, 256, (2, 200), dtype=np.uint8)
    want = np.asarray(ot.encode(data, guard_bands=gb, modulation=scheme,
                              dtype=jnp.complex64))
    got = ott.encode(data, guard_bands=gb,
                     modulation=convert.modulation_from_reference(scheme),
                     device="cpu").numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda m: m.value)
@pytest.mark.parametrize("gb", [False, True])
def test_encode_complex128_matches_golden(golden, scheme, gb):
    got = ott.encode(np.arange(200, dtype=np.uint8), guard_bands=gb,
                     modulation=convert.modulation_from_reference(scheme),
                     dtype=torch.complex128, device="cpu").numpy()
    want = golden[f"tx_{scheme.value}_gb{int(gb)}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_encode_accepts_bytes_and_tensors():
    payload = bytes(range(40))
    a = ott.encode(payload, guard_bands=True, modulation=ott.Modulation.QPSK,
                   device="cpu")
    b = ott.encode(torch.arange(40, dtype=torch.uint8), guard_bands=True,
                   modulation=ott.Modulation.QPSK)
    assert torch.equal(a, b)
    assert a.shape[-1] == ott.frame_len(40, ott.Modulation.QPSK, True)


def _tx(batch=2, payload=256, mod=ot.Modulation.QPSK):
    data = np.random.default_rng(9).integers(0, 256, (batch, payload),
                                             dtype=np.uint8)
    return np.array(ot.encode(data, guard_bands=True, modulation=mod,
                              dtype=jnp.complex64))


def test_channel_matches_jax_at_high_snr():
    tx = _tx()
    want = np.asarray(ot.channel(jnp.asarray(tx), snr=300.0,
                                 key=jax.random.key(0)))
    got = ott.channel(torch.as_tensor(tx), snr=300.0,
                      generator=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape == (tx.shape[0], tx.shape[1] + 63)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_channel_noise_power_at_snr20(dtype):
    """E|noise|^2 = |pseudo-variance| / snr_lin / 3: the complex amplitude
    sqrt(0.5 * noise_var) times U(-1,1) + jU(-1,1), whose power is 2/3."""
    tx = torch.as_tensor(_tx(batch=4, payload=512)).to(dtype)
    rd = torch.float64 if dtype == torch.complex128 else torch.float32
    clean = convolve_direct(tx, torch.as_tensor(constants.CHANNEL_TAPS, dtype=rd))
    rx = ott.channel(tx, snr=20.0, generator=torch.Generator().manual_seed(4))
    measured = ((rx - clean).abs() ** 2).mean(-1).double()
    diff = clean.mean(-1, keepdim=True) - clean
    target = (diff * diff).mean(-1).abs().double() / 10 ** 2.0 / 3.0
    np.testing.assert_allclose(measured.numpy(), target.numpy(), rtol=0.05)


def test_channel_cfo_is_a_linear_phase():
    """At SNR 300 with a CFO draw, rx/clean = exp(+j f_delta (n+1)) with
    f_delta = pi * U / 80 in [0, pi/80)."""
    tx = torch.as_tensor(_tx(batch=3))
    clean = convolve_direct(tx, torch.as_tensor(constants.CHANNEL_TAPS,
                                                dtype=torch.float32))
    rx = ott.channel(tx, snr=300.0, timing_error=True,
                     generator=torch.Generator().manual_seed(2))
    keep = clean.abs() > 1e-2
    for r in range(tx.shape[0]):
        n = torch.nonzero(keep[r])[:, 0]
        ratio = rx[r, n] / clean[r, n]
        f = torch.angle(ratio[1:] * ratio[:-1].conj()) / (n[1:] - n[:-1])
        fd = float(f.median())
        assert 0.0 <= fd < np.pi / 80
        np.testing.assert_allclose(f.numpy(), fd, atol=1e-4)
        phase = torch.angle(ratio * torch.polar(torch.ones(len(n)),
                                                -fd * (n + 1).float()))
        assert float(phase.abs().max()) < 1e-2
