"""``decode(return_diagnostics=True)`` and its taps against ofdm_tpu's, the
float64 oracle grid through the port, and the frozen captures that hold the
card to the JAX package's bytes (tests/gen_torch_fixtures.py wrote them).

The port decodes in complex64 where JAX with x64 keeps the input's
precision, so signals are compared to 1e-4 of their largest magnitude and
bytes, offsets and payloads exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
import ofdm_tpu_torch as ott
from ofdm_tpu.obs import taps as jtaps
from ofdm_tpu.phy.rx import decode_aligned as jax_decode_aligned
from ofdm_tpu_torch import convert
from ofdm_tpu_torch.io.iqfile import read_iq
from ofdm_tpu_torch.obs import taps

from .oracle_rx import oracle_decode

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SIGNALS = ("chunk6_pre", "chunk6_post", "h_k", "equalized")
TAP_NAMES = {"preq_correction_3a": "chunk6_pre",
             "post_correction_3a": "chunk6_post",
             "hk_estimate_3a": "h_k", "no_phaseoffset": "equalized"}


def _rx(mod, guard_bands, cfo, snr, key, n=150):
    data = np.random.default_rng(key).integers(0, 256, n, dtype=np.uint8)
    tx = ot.encode(data, guard_bands=guard_bands, modulation=mod,
                   dtype=jnp.complex64)
    rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(key))
    return data, np.asarray(rx).astype(np.complex64)


def _close(got, want, what):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


CASES = [(ot.Modulation.QPSK, True, True, 25.0, 3),
         (ot.Modulation.BPSK, False, False, 30.0, 4),
         (ot.Modulation.QAM64, True, True, 45.0, 5),
         (ot.Modulation.QAM256, True, False, 55.0, 6)]


@pytest.mark.parametrize("mod,guard_bands,cfo,snr,key", CASES,
                         ids=[c[0].value for c in CASES])
def test_decode_diagnostics_match_jax(mod, guard_bands, cfo, snr, key):
    data, rx = _rx(mod, guard_bands, cfo, snr, key)
    want, wdiag = ot.decode(jnp.asarray(rx), guard_bands=guard_bands,
                            modulation=mod, return_diagnostics=True)
    got, diag = ott.decode(rx, guard_bands=guard_bands,
                           modulation=convert.modulation_from_reference(mod),
                           device="cpu", return_diagnostics=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, data)
    assert set(diag) == set(wdiag)
    assert isinstance(diag["offset"], int) and diag["offset"] == wdiag["offset"]
    for name in SIGNALS:
        assert isinstance(diag[name], np.ndarray)
        assert diag[name].dtype == np.complex64, name
        _close(diag[name], np.asarray(wdiag[name]), name)
    assert diag["f_delta"].shape == () and diag["f_delta"].dtype == np.float32
    np.testing.assert_allclose(diag["f_delta"], np.asarray(wdiag["f_delta"]),
                               atol=1e-6)
    # the keys and shapes of JAX's decode_aligned diag, one row, no batch axis
    cfg = ott.DEFAULT_CONFIG
    assert diag["chunk6_pre"].shape == diag["chunk6_post"].shape == (cfg.sym_len,)
    assert diag["h_k"].shape == (cfg.n_fft,)
    n_chunks = -(-(rx.shape[0] - diag["offset"]) // cfg.sym_len)
    assert diag["equalized"].shape == (
        (n_chunks - cfg.n_sync_chunks) * cfg.carriers_per_block(guard_bands),)


def test_plain_decode_returns_the_payload_only():
    data, rx = _rx(ot.Modulation.QPSK, True, True, 25.0, 3)
    out = ott.decode(rx, guard_bands=True, modulation=ott.Modulation.QPSK,
                     device="cpu")
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, data)


def test_equalized_is_computed_only_on_request(monkeypatch):
    """A plain decode, decode_aligned and the stream decoders never pay for
    the diagnostics' constellation."""
    from ofdm_tpu_torch.phy import rx as rx_mod
    calls = []
    real = rx_mod.equalized_symbols
    monkeypatch.setattr(rx_mod, "equalized_symbols",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, rx = _rx(ot.Modulation.QPSK, True, False, 30.0, 8)
    kw = dict(guard_bands=True, modulation=ott.Modulation.QPSK, device="cpu")
    ott.decode(rx, **kw)
    aligned = torch.as_tensor(rx[:12 * 80])
    _, d = ott.decode_aligned(aligned, n_chunks=12, guard_bands=True,
                              modulation=ott.Modulation.QPSK)
    assert calls == [] and d["equalized"] is None
    ott.decode(rx, return_diagnostics=True, **kw)
    assert calls == [1]


def test_taps_written_under_the_reference_names(tmp_path):
    data, rx = _rx(ot.Modulation.QPSK, True, True, 25.0, 3)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jtaps.enable(jdir)
    try:
        ot.decode(jnp.asarray(rx), guard_bands=True, modulation=ot.Modulation.QPSK)
    finally:
        jtaps.disable()
    taps.enable(tdir)
    try:
        out, diag = ott.decode(rx, guard_bands=True,
                               modulation=ott.Modulation.QPSK, device="cpu",
                               return_diagnostics=True)
        # and without the diagnostics asked for
        plain = ott.decode(rx, guard_bands=True, modulation=ott.Modulation.QPSK,
                           device="cpu")
    finally:
        taps.disable()
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(plain, data)
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert names == sorted(f"{t}_{part}.npy" for t in TAP_NAMES
                           for part in ("reals", "imag"))
    for tap, key in TAP_NAMES.items():
        for part, take in (("reals", np.real), ("imag", np.imag)):
            mine = np.load(tdir / f"{tap}_{part}.npy")
            assert mine.dtype == np.float64
            np.testing.assert_array_equal(mine, take(diag[key]).astype(np.float64))
            theirs = np.load(jdir / f"{tap}_{part}.npy")
            _close(mine + 0j, theirs + 0j, f"{tap}_{part}")


# --- the float64 oracle grid, by bytes ----------------------------------------

@pytest.mark.parametrize("gb,mod,snr,cfo,key", [
    (False, "bpsk", 30.0, False, 1),
    (False, "qpsk", 30.0, True, 2),
    (True, "bpsk", 20.0, True, 3),
    (True, "qpsk", 25.0, False, 4),
    (True, "qpsk", 10.0, True, 5),   # noisy: bit errors present, still equal
])
def test_port_matches_the_float64_oracle(gb, mod, snr, cfo, key):
    """tests/test_oracle_parity.py's grid: the naive float64 loops of
    tests/oracle_rx.py, JAX's decode_aligned in complex128 and the port's in
    complex64 give the same raw bytes (header included, untruncated)."""
    data = bytes(range(120))
    tx = ot.encode(data, guard_bands=gb, modulation=ot.Modulation(mod),
                   dtype=jnp.complex128)
    rx = np.asarray(ot.channel(tx, snr=snr, timing_error=cfo,
                               key=jax.random.key(key)))
    expected = oracle_decode(rx, gb, mod)
    off = max(int(ott.sync_offset(torch.tensor(rx))), 0)
    assert off == max(int(ot.sync_offset(jnp.asarray(rx))), 0)
    aligned = rx[off:]
    n_chunks = -(-len(aligned) // 80)
    aligned = np.concatenate([aligned, np.zeros(n_chunks * 80 - len(aligned),
                                                np.complex128)])
    want, _ = jax_decode_aligned(jnp.asarray(aligned), n_chunks=n_chunks,
                                 guard_bands=gb, modulation=ot.Modulation(mod))
    got, _ = ott.decode_aligned(torch.as_tensor(aligned), n_chunks=n_chunks,
                                guard_bands=gb, modulation=ott.Modulation(mod))
    np.testing.assert_array_equal(np.asarray(want), expected)
    np.testing.assert_array_equal(got.numpy(), expected)


# --- the frozen captures ------------------------------------------------------

def load_capture(name):
    """(rows complex64 [R, T], the npz) of a capture written by
    tests/gen_torch_fixtures.py, read with the port's ``read_iq``."""
    exp = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    rows = read_iq(os.path.join(GOLDEN_DIR, f"{name}.dat"), dtype=np.complex64)
    return rows.reshape(-1, int(exp["row_len"])), exp


CAPTURES = ["torch_capture_qam256", "torch_capture_bpsk_gb"]


@pytest.mark.parametrize("name", CAPTURES)
def test_frozen_capture_decode_frame(name):
    rows, exp = load_capture(name)
    mod = ott.Modulation(str(exp["modulation"]))
    assert rows.shape[0] == 4 and exp["payloads"].shape[0] == 4
    kw = dict(n_blocks=int(exp["n_blocks"]), guard_bands=True, modulation=mod)
    out = ott.decode_frame(torch.as_tensor(rows), **kw)
    np.testing.assert_array_equal(out.numpy(), exp["decoded"])
    planes = torch.stack([torch.as_tensor(rows.real), torch.as_tensor(rows.imag)],
                         dim=1)
    np.testing.assert_array_equal(ott.decode_frame_planar(planes, **kw).numpy(),
                                  exp["decoded"])
    # and what the file froze is what the JAX package decodes today
    want = np.asarray(ot.decode_frame(
        jnp.asarray(rows), n_blocks=int(exp["n_blocks"]), guard_bands=True,
        modulation=ot.Modulation(mod.value)))
    np.testing.assert_array_equal(exp["decoded"], want)


def test_qam256_capture_rows_carry_their_payloads():
    rows, exp = load_capture("torch_capture_qam256")
    n = exp["payloads"].shape[1]
    assert n == 8192
    np.testing.assert_array_equal(exp["decoded"][:, 16:16 + n], exp["payloads"])


@pytest.mark.parametrize("name", CAPTURES)
def test_frozen_capture_decode(name):
    rows, exp = load_capture(name)
    mod = ott.Modulation(str(exp["modulation"]))
    pay, diag = ott.decode(rows[0], guard_bands=True, modulation=mod,
                           device="cpu", return_diagnostics=True)
    np.testing.assert_array_equal(pay, exp["decode_payload"])
    np.testing.assert_array_equal(pay, exp["payloads"][0])
    assert diag["offset"] == int(exp["decode_offset"])
    assert diag["offset"] == int(ott.sync_offset(torch.as_tensor(rows[0])))
