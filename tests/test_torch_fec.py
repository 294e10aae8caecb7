"""The port's FEC layer against ofdm_tpu's: Hamming(7,4) bit for bit (the
wire-format cases of tests/test_fec.py, odd lengths and one flipped bit per
codeword), the block interleaver, bit-error counting, the Reed-Solomon copy
and the normalized-matched-filter sync quality, on the same numpy inputs."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu.fec import hamming as jhamming
from ofdm_tpu.fec import interleave as jinterleave
from ofdm_tpu.fec import reed_solomon as jrs
from ofdm_tpu.obs import analysis as janalysis
from ofdm_tpu.ops import xcorr as jxcorr
import ofdm_tpu_torch as ott
from ofdm_tpu_torch import DEFAULT_CONFIG, constants
from ofdm_tpu_torch.fec import hamming, interleave
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.obs import analysis
from ofdm_tpu_torch.ops import xcorr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LENGTHS = [1, 2, 3, 4, 7, 64, 200, 333]


def _flip_one_bit_per_codeword(coded: np.ndarray, n_bytes: int, seed: int):
    """Flip one random bit inside every 7-bit codeword of the stream."""
    bits = np.unpackbits(coded, axis=-1, bitorder="little")
    rng = np.random.default_rng(seed)
    for cw in range(2 * n_bytes):
        bits[..., 7 * cw + rng.integers(0, 7)] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little")


@pytest.mark.parametrize("n", LENGTHS)
def test_hamming_encode_bitwise(n):
    data = np.random.default_rng(11 + n).integers(0, 256, n, dtype=np.uint8)
    want = np.asarray(jhamming.encode(jnp.asarray(data)))
    got = hamming.encode(torch.as_tensor(data))
    assert got.dtype == torch.uint8 and got.shape[-1] == hamming.encoded_len(n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", LENGTHS)
def test_hamming_decode_corrects_one_bit_per_codeword(n):
    data = np.random.default_rng(12 + n).integers(0, 256, n, dtype=np.uint8)
    bad = _flip_one_bit_per_codeword(np.asarray(jhamming.encode(jnp.asarray(data))),
                                     n, seed=n)
    want = np.asarray(jhamming.decode(jnp.asarray(bad), n))
    got = hamming.decode(torch.as_tensor(bad), n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def test_hamming_batched_matches_jax():
    """[3, 96] batches, random multi-bit damage included (where the code can
    miscorrect, the two must still agree bit for bit)."""
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, (3, 96), dtype=np.uint8)
    enc = hamming.encode(torch.as_tensor(data))
    np.testing.assert_array_equal(enc.numpy(),
                                  np.asarray(jhamming.encode(jnp.asarray(data))))
    bad = enc.numpy().copy()
    for pos in rng.integers(0, bad.shape[-1], 20):
        bad[rng.integers(0, 3), pos] ^= np.uint8(1) << rng.integers(0, 8)
    for n in (96, 95, 50):
        np.testing.assert_array_equal(
            hamming.decode(torch.as_tensor(bad), n).numpy(),
            np.asarray(jhamming.decode(jnp.asarray(bad), n)))
    np.testing.assert_array_equal(hamming.decode(enc, 96).numpy(), data)


def test_hamming_tables_equal():
    np.testing.assert_array_equal(hamming._G, jhamming._G)
    np.testing.assert_array_equal(hamming._H, jhamming._H)


@pytest.mark.parametrize("depth", [1, 3, 8, 17])
def test_interleave_device_matches_host(depth):
    data = np.random.default_rng(depth).integers(0, 256, (2, 3, 101), dtype=np.uint8)
    got = interleave.interleave_device(torch.as_tensor(data), depth)
    for i in np.ndindex(2, 3):
        host = jinterleave.interleave(data[i], depth)
        np.testing.assert_array_equal(interleave.interleave(data[i], depth), host)
        np.testing.assert_array_equal(got[i].numpy(), host)
        back = interleave.deinterleave_device(got[i], depth, 101)
        np.testing.assert_array_equal(back.numpy(), data[i])
        np.testing.assert_array_equal(
            interleave.deinterleave(host, depth, 101),
            jinterleave.deinterleave(host, depth, 101))
    np.testing.assert_array_equal(
        interleave.deinterleave_device(got, depth, 101).numpy(), data)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jinterleave.interleave_device(data, depth)))


def test_bit_errors_and_analysis_match_jax():
    rng = np.random.default_rng(21)
    a = rng.integers(0, 256, (4, 300), dtype=np.uint8)
    b = a.copy()
    b[rng.random(b.shape) < 0.05] ^= rng.integers(1, 256, dtype=np.uint8)
    got = analysis.bit_errors(torch.as_tensor(a), torch.as_tensor(b))
    want = np.asarray(janalysis.bit_errors(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    port, ref = ott.Analysis.new(a, b), janalysis.Analysis.new(a, b)
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert ott.Analysis.new(a, a).num_errs == 0 < port.num_errs
    assert dataclasses.astuple(ott.Analysis.new(bytes(a[0]), bytes(b[0]))) == \
        dataclasses.astuple(ot.Analysis.new(bytes(a[0]), bytes(b[0])))


def test_reed_solomon_copy_is_byte_equal():
    assert (ROOT / "ofdm_tpu_torch/fec/reed_solomon.py").read_bytes() == \
        (ROOT / "ofdm_tpu/fec/reed_solomon.py").read_bytes()


def test_reed_solomon_rows_match_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 400), dtype=np.uint8)
    rows = np.stack([rs.encode_stream(d) for d in data])
    rows[0, 10] ^= 0x5A                        # correctable
    rows[1, rng.integers(0, 255, 40)] ^= 0xFF  # past the code's reach
    got, ok = rs.decode_payload_rows(rows, 400)
    want, ok_want = jrs.decode_payload_rows(rows, 400)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, ok_want)
    np.testing.assert_array_equal(got[0], data[0])


def _quality_streams():
    """tests/test_detection_thresholds.py's continuous-gate streams: one
    frame at 700 in noise at 0, 5 and 30 dB, plus noise alone."""
    data = np.random.default_rng(11).integers(0, 256, 64, dtype=np.uint8)
    tx = np.asarray(ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK,
                              dtype=jnp.complex128))
    out = []
    for snr_db, with_frame in ((0.0, True), (5.0, True), (30.0, True), (0.0, False)):
        rng = np.random.default_rng(int(snr_db) + 7)
        n_var = np.mean(np.abs(tx) ** 2) / 10 ** (snr_db / 10.0)
        s = np.sqrt(n_var / 2) * (rng.standard_normal(4176)
                                  + 1j * rng.standard_normal(4176))
        if with_frame:
            s[700:700 + tx.shape[0]] += tx[:4176 - 700]
        out.append(s)
    return np.stack(out).astype(np.complex64)


def test_locking_sync_quality_matches_jax():
    s = _quality_streams()
    tpl = constants.locking_for(DEFAULT_CONFIG).astype(np.complex64)
    off_j, rho_j = jxcorr.locking_sync_quality(jnp.asarray(s), jnp.asarray(tpl))
    off, rho = xcorr.locking_sync_quality(torch.as_tensor(s), tpl)
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=1e-5)
    assert abs(off.numpy()[:3] - 699).max() <= 1 and rho[3] < 0.2 < 0.4 < rho[0]


def test_window_energy_float64_sum():
    """E_window after a loud stretch: the float32 running sum of the JAX
    package loses a quiet gap entirely (reads 0); the port's does not."""
    loud = np.full(3000, 1.0 + 1.0j, np.complex64)
    quiet = np.full(200, 1e-4, np.complex64)
    x = np.concatenate([loud, quiet])
    e = xcorr.window_energy(torch.as_tensor(x), 80, 3120).numpy()
    gap = 80 * float(np.abs(quiet[0]) ** 2)        # the f32 squares, summed exactly
    # 7.5e9 between the loud and the quiet sample: float64 keeps ~1e-5
    np.testing.assert_allclose(e[3100:3120], gap, rtol=1e-4)
    cs = np.concatenate([[0], np.cumsum(np.abs(x) ** 2, dtype=np.float32)])
    assert (cs[3180:3200] - cs[3100:3120] == 0).all()   # the float32 form
    np.testing.assert_allclose(e[:2900], 160.0)


def test_fec_on_the_inputs_device():
    x = torch.arange(50, dtype=torch.uint8)
    for out in (hamming.encode(x), hamming.decode(hamming.encode(x), 50),
                interleave.interleave_device(x, 4),
                analysis.bit_errors(x, x)):
        assert out.device == x.device
