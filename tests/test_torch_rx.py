"""The slice as a whole: the port's receiver against ofdm_tpu's on received
samples made by the JAX package (its channel, its noise), byte for byte.

Rows the JAX decoder itself loses are left out of the comparison: the
port's sync sums in another order, and on a lost row a near-tie may resolve
elsewhere (ofdm_tpu_torch/PARITY.md).  At these SNRs every row decodes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu_torch import convert

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PAYLOAD = 256


def _jax_rx(mod, guard_bands, cfo, snr, batch=3, key=3):
    data = np.random.default_rng(7).integers(0, 256, (batch, PAYLOAD),
                                             dtype=np.uint8)
    tx = ot.encode(data, guard_bands=guard_bands, modulation=mod,
                   dtype=jnp.complex64)
    rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(key))
    nb = ot.n_data_blocks(PAYLOAD, mod, guard_bands)
    frame = 880 + nb * 80
    rx = np.array(rx.astype(jnp.complex64))
    rx = np.pad(rx, ((0, 0), (0, max(0, frame - rx.shape[-1]))))
    return data, rx, nb


CASES = [(ot.Modulation.QAM64, True, 45.0), (ot.Modulation.QPSK, True, 45.0),
         (ot.Modulation.QAM256, True, 55.0), (ot.Modulation.BPSK, False, 45.0)]


@pytest.mark.parametrize("mod,guard_bands,snr", CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
@pytest.mark.parametrize("cfo", [False, True])
def test_decode_frame_matches_jax(mod, guard_bands, snr, cfo):
    data, rx, nb = _jax_rx(mod, guard_bands, cfo, snr)
    want = np.asarray(ot.decode_frame(jnp.asarray(rx), n_blocks=nb,
                                      guard_bands=guard_bands, modulation=mod))
    port = convert.modulation_from_reference(mod)
    got = ott.decode_frame(torch.as_tensor(rx), n_blocks=nb,
                           guard_bands=guard_bands, modulation=port).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    good = (want[:, 16:16 + PAYLOAD] == data).all(axis=1)
    assert good.sum() >= len(good) - 1, "the reference lost rows"
    np.testing.assert_array_equal(got[good], want[good])
    planes = torch.stack([torch.as_tensor(rx).real, torch.as_tensor(rx).imag],
                         dim=1)
    got_p = ott.decode_frame_planar(planes, n_blocks=nb, guard_bands=guard_bands,
                                    modulation=port).numpy()
    np.testing.assert_array_equal(got_p, got)


def test_decode_frame_reference_estimator_and_search_window():
    data, rx, nb = _jax_rx(ot.Modulation.QPSK, True, True, 45.0, key=5)
    kw = dict(n_blocks=nb, guard_bands=True)
    want = np.asarray(ot.decode_frame(jnp.asarray(rx), modulation=ot.Modulation.QPSK,
                                      cfo_estimator="reference", **kw))
    got = ott.decode_frame(torch.as_tensor(rx), modulation=ott.Modulation.QPSK,
                           cfo_estimator="reference", **kw).numpy()
    good = (want[:, 16:16 + PAYLOAD] == data).all(axis=1)
    np.testing.assert_array_equal(got[good], want[good])
    # the frame starts within the first symbol: a bounded scan finds it too
    win = ott.decode_frame(torch.as_tensor(rx), modulation=ott.Modulation.QPSK,
                           search_window=400, **kw).numpy()
    np.testing.assert_array_equal(win[:, 16:16 + PAYLOAD], data)


def test_decode_frame_shapes():
    data, rx, nb = _jax_rx(ot.Modulation.QPSK, True, False, 45.0)
    one = ott.decode_frame(torch.as_tensor(rx[0]), n_blocks=nb, guard_bands=True,
                           modulation=ott.Modulation.QPSK)
    assert one.shape == (nb * 12,)
    np.testing.assert_array_equal(one[16:16 + PAYLOAD].numpy(), data[0])
    # rows shorter than the frame are zero-padded
    short = torch.as_tensor(rx[:, :880 + (nb - 1) * 80])
    out = ott.decode_frame(short, n_blocks=nb, guard_bands=True,
                           modulation=ott.Modulation.QPSK)
    assert out.shape == (3, nb * 12)


@pytest.fixture(scope="module")
def capture():
    exp = np.load(os.path.join(GOLDEN_DIR, "rx_capture_expected.npz"))
    inter = np.fromfile(os.path.join(GOLDEN_DIR, "rx_capture_qam64.dat"),
                        dtype="<f4")            # interleaved fc32, as iqfile
    rx = (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)
    return exp, rx


def test_frozen_capture_decode_frame(capture):
    exp, rx = capture
    out = ott.decode_frame(torch.as_tensor(rx), n_blocks=int(exp["n_blocks"]),
                           guard_bands=True, modulation=ott.Modulation.QAM64)
    np.testing.assert_array_equal(out.numpy(), exp["decoded"])


def test_frozen_capture_decode(capture):
    exp, rx = capture
    pay = ott.decode(torch.as_tensor(rx), guard_bands=True,
                     modulation=ott.Modulation.QAM64)
    np.testing.assert_array_equal(pay, exp["payload"])
    np.testing.assert_array_equal(
        pay, np.asarray(ot.decode(jnp.asarray(rx), guard_bands=True,
                                  modulation=ot.Modulation.QAM64)))


@pytest.mark.parametrize("mod", list(ot.Modulation), ids=lambda m: m.value)
def test_decode_golden_frames(mod):
    """The frozen complex128 tx frames, delayed by 7 samples, decode exactly
    (as tests/test_golden.py holds the JAX decoder to)."""
    tx = np.load(os.path.join(GOLDEN_DIR, "tx_frames.npz"))[f"tx_{mod.value}_gb1"]
    delayed = np.concatenate([np.zeros(7, tx.dtype), tx])
    out = ott.decode(delayed, guard_bands=True,
                     modulation=convert.modulation_from_reference(mod),
                     device="cpu")
    np.testing.assert_array_equal(out, np.arange(200, dtype=np.uint8))


def test_decode_matches_jax_with_cfo():
    data, rx, _ = _jax_rx(ot.Modulation.QPSK, True, True, 40.0, batch=1, key=11)
    want = np.asarray(ot.decode(jnp.asarray(rx[0]), guard_bands=True,
                                modulation=ot.Modulation.QPSK))
    got = ott.decode(torch.as_tensor(rx[0]), guard_bands=True,
                     modulation=ott.Modulation.QPSK)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[0])


@pytest.mark.parametrize("n", [0, 100, 799])
def test_decode_raises_on_short_stream(n):
    with pytest.raises(ott.DecodeError):
        ott.decode(torch.zeros(n, dtype=torch.complex64))


def test_decode_raises_when_the_frame_starts_too_late():
    tx = ott.encode(bytes(range(40)), guard_bands=True,
                    modulation=ott.Modulation.QPSK, device="cpu")
    late = torch.cat([torch.zeros(1000, dtype=tx.dtype), tx[:700]])
    with pytest.raises(ott.DecodeError, match="not long enough"):
        ott.decode(late, guard_bands=True, modulation=ott.Modulation.QPSK)
