"""The port's time-sharded decode and channel on an 8-rank gloo world against
the JAX package's single-device ``decode_frame``, byte for byte.

The cases of tests/test_timeshard.py without its jit-retrace one, on the
meshes (1, 8), (2, 4) and (4, 2) of one world of eight CPU processes
(``tests/test_torch_world.py``; the whole world under one 300 s limit).  On
(1, 8) a shard is 640 samples, so the 12 boundary offsets probe shard
interiors, boundaries and a frame across three or more shards, where the
halo spill and the sums over owned chunks and bytes do the work.  The
inputs are made here from seeded numpy noise and payloads, framed by the
JAX package (complex64); the references are computed while the world runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu import constants as jconstants
from ofdm_tpu.config import DEFAULT_CONFIG, FrameConfig
from ofdm_tpu.fec import hamming as jhamming
from ofdm_tpu.phy.streaming import coded_len
from tests.test_torch_world import World, rows, time_blocks

QPSK, QAM16, QAM64 = ot.Modulation.QPSK, ot.Modulation.QAM16, ot.Modulation.QAM64
BOUNDARY_OFFSETS = [0, 1, 79, 80, 639, 640, 641, 1000, 1279, 1281, 2555, 3600]
MIXED = {"mixed_24": (2, 4), "mixed_42": (4, 2)}
HAM_BYTES = 64


def _c64(x) -> np.ndarray:
    return np.asarray(x).astype(np.complex64)


def _frame(rng, payload_len, modulation, guard_bands, snr=None, key=0):
    data = rng.integers(0, 256, payload_len, dtype=np.uint8)
    tx = np.asarray(ot.encode(data, guard_bands=guard_bands,
                              modulation=modulation, dtype=jnp.complex64))
    if snr is not None:
        tx = np.asarray(ot.channel(jnp.asarray(tx), snr=snr,
                                   key=jax.random.key(key)))
    return data, tx


def _stream(rng, tx, offsets, t):
    """[len(offsets), t] noise-floor streams, the frame at offsets[i]."""
    s = 0.003 * (rng.standard_normal((len(offsets), t))
                 + 1j * rng.standard_normal((len(offsets), t)))
    for i, off in enumerate(offsets):
        s[i, off:off + tx.shape[-1]] += tx
    return _c64(s)


def _inputs():
    rng = np.random.default_rng(7)
    cases, arrays, need = [], {}, {}

    def add(name, mesh, x, data, kind="timeshard", **kw):
        cases.append(dict(name=name, kind=kind, mesh=list(mesh), kw=kw))
        arrays[f"{name}/x"] = x
        need[name] = (x, data, kw)

    qpsk_kw = dict(guard_bands=True, modulation="qpsk")
    data, tx = _frame(rng, 90, QPSK, True)
    nb = ot.n_data_blocks(90, QPSK, True)
    add("boundary", (1, 8), _stream(rng, tx, BOUNDARY_OFFSETS, 5120), data,
        n_blocks=nb, **qpsk_kw)

    data, tx = _frame(rng, 90, QAM16, True, snr=35.0, key=11)
    nb16 = ot.n_data_blocks(90, QAM16, True)
    x = _stream(rng, tx, [0, 639, 641, 1281], 5760)
    for derot in ("matrix", "stream"):
        add(f"qam16_cfo_{derot}", (1, 8), x, data, n_blocks=nb16,
            guard_bands=True, modulation="qam16", derot_impl=derot)

    data, tx = _frame(rng, 90, QPSK, False, snr=35.0, key=13)
    add("qpsk_no_guard_bands", (1, 8),
        _stream(rng, tx, [0, 639, 641, 1281], 5760), data,
        n_blocks=ot.n_data_blocks(90, QPSK, False), guard_bands=False,
        modulation="qpsk", derot_impl="matrix")

    data, tx = _frame(rng, 60, QPSK, True, snr=30.0, key=2)
    for name, (n_data, n_time) in MIXED.items():
        add(name, (n_data, n_time),
            _stream(rng, tx, [0, 315, 963, 1280], 4 * n_time * 80 * 8), data,
            n_blocks=ot.n_data_blocks(60, QPSK, True), **qpsk_kw)

    data, tx = _frame(rng, 64, QAM64, False, snr=45.0, key=3)
    add("qam64_no_guard_bands", (1, 8), _stream(rng, tx, [777, 1601], 3840),
        data, n_blocks=ot.n_data_blocks(64, QAM64, False), guard_bands=False,
        modulation="qam64")

    plen = coded_len(HAM_BYTES, "hamming")
    user = rng.integers(0, 256, (3, HAM_BYTES), dtype=np.uint8)
    frames = np.asarray(ot.encode_hamming(jnp.asarray(user), guard_bands=True,
                                          modulation=QPSK, dtype=jnp.complex64))
    hs = np.zeros((3, 5760), np.complex64)
    for i, off in enumerate([0, 641, 2555]):
        hs[i, off:off + frames.shape[-1]] = frames[i]
    ham_kw = dict(n_blocks=ot.n_data_blocks(plen, QPSK, True), **qpsk_kw)
    add("hamming_tail", (1, 8), hs, user, fec="hamming", payload_len=plen,
        data_len=HAM_BYTES, **ham_kw)
    add("hamming_raw", (1, 8), hs, user, **ham_kw)

    data, tx = _frame(rng, 90, QPSK, True)
    _, tx2 = _frame(rng, 90, QPSK, True)
    sw = np.zeros((2, 5120), np.complex64)
    for i, off in enumerate([37, 100]):
        sw[i, off:off + tx.shape[-1]] = tx
        decoy = 2600 + i                 # a louder frame, another payload
        sw[i, decoy:decoy + tx2.shape[-1]] += 1.5 * tx2
    add("search_window", (1, 8), sw, data, n_blocks=nb, search_window=256,
        **qpsk_kw)
    add("no_search_window", (1, 8), sw, data, n_blocks=nb, **qpsk_kw)

    # a 160-tap locking template: the sync takes the conv correlation
    geo = dict(n_fft=128, cp_len=32, n_training=3, n_preamble=2,
               locking_seed=7)
    gdata = rng.integers(0, 256, 200, dtype=np.uint8)
    gtx = np.asarray(ot.channel(ot.encode(gdata, modulation=QPSK,
                                          cfg=FrameConfig(**geo),
                                          dtype=jnp.complex64),
                                snr=30.0, key=jax.random.key(5)))
    add("geometry_160_taps", (1, 8), _stream(rng, gtx, [0, 1000, 2900], 5120),
        gdata, n_blocks=ot.n_data_blocks(200, QPSK, False, FrameConfig(**geo)),
        guard_bands=False, modulation="qpsk", cfg=geo)

    xs = _c64(rng.standard_normal((4, 4 * 640))
              + 1j * rng.standard_normal((4, 4 * 640)))
    cases.append(dict(name="channel_conv", kind="channel", mesh=[2, 4],
                      kw=dict(snr=None, timing_error=False)))
    arrays["channel_conv/x"] = xs
    need["channel_conv"] = (xs, None, {})

    pdata = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    cases.append(dict(name="pipeline_24", kind="pipeline", mesh=[2, 4],
                      kw=dict(payload_len=64, guard_bands=True,
                              modulation="qpsk", snr=30.0, timing_error=True,
                              seed=5)))
    arrays["pipeline_24/data"] = pdata
    need["pipeline_24"] = (None, pdata, {})
    return cases, arrays, need


def _reference(x, kw) -> np.ndarray:
    """JAX's decode_frame (+ its Hamming tail) on the same samples."""
    mod = ot.Modulation(kw["modulation"])
    cfg = FrameConfig(**kw["cfg"]) if "cfg" in kw else DEFAULT_CONFIG
    out = np.asarray(ot.decode_frame(
        jnp.asarray(x), n_blocks=kw["n_blocks"], guard_bands=kw["guard_bands"],
        modulation=mod, search_window=kw.get("search_window"), cfg=cfg))
    if kw.get("fec") == "hamming":
        out = np.asarray(jhamming.decode(
            jnp.asarray(out[:, 16:16 + kw["payload_len"]]), kw["data_len"]))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases, arrays, need = _inputs()
    world = World({"cases": cases}, arrays, 8, tmp_path_factory.mktemp("w8"),
                  device="cpu")
    refs = {name: _reference(x, kw) for name, (x, _, kw) in need.items()
            if x is not None and "n_blocks" in kw}
    reports, outputs = world.wait(timeout=300)
    return dict(reports=reports, outputs=outputs, refs=refs, need=need)


def _rows(run, case, key="out"):
    return rows(run["reports"], run["outputs"], case, key)


def test_world_started(run):
    assert all(r["ok"] and r["world"] == 8 for r in run["reports"])


@pytest.mark.parametrize("i", range(len(BOUNDARY_OFFSETS)),
                         ids=[f"offset{o}" for o in BOUNDARY_OFFSETS])
def test_timesharded_matches_decode_frame_boundary_offsets(run, i):
    ts = _rows(run, "boundary")[i]
    np.testing.assert_array_equal(ts, run["refs"]["boundary"][i])
    np.testing.assert_array_equal(ts[16:106], run["need"]["boundary"][1])


@pytest.mark.parametrize("case", ["qam16_cfo_matrix", "qam16_cfo_stream",
                                  "qpsk_no_guard_bands", *MIXED,
                                  "geometry_160_taps"])
def test_timesharded_parity(run, case):
    """Both derot routes on QAM16 with the channel's CFO, the no-guard-band
    arm (every bin), the mixed meshes with multipath, CFO and noise, and a
    160-tap template (n_fft 128, symbols of 160), whose sync takes the conv
    correlation."""
    ts = _rows(run, case)
    np.testing.assert_array_equal(ts, run["refs"][case])
    data = run["need"][case][1]
    np.testing.assert_array_equal(ts[:, 16:16 + len(data)],
                                  np.tile(data, (ts.shape[0], 1)))


def test_timesharded_qam64_no_guard_bands(run):
    np.testing.assert_array_equal(_rows(run, "qam64_no_guard_bands"),
                                  run["refs"]["qam64_no_guard_bands"])


def test_timesharded_hamming_fec_tail(run):
    ts = _rows(run, "hamming_tail")
    np.testing.assert_array_equal(ts, run["refs"]["hamming_tail"])
    np.testing.assert_array_equal(ts, run["need"]["hamming_tail"][1])


def test_timesharded_search_window(run):
    """A louder decoy past the window does not take the sync; in the window
    the bytes are decode_frame's with the same window, and without it the
    decoy wins."""
    ts = _rows(run, "search_window")
    np.testing.assert_array_equal(ts, run["refs"]["search_window"])
    np.testing.assert_array_equal(ts[:, 16:106],
                                  np.tile(run["need"]["search_window"][1], (2, 1)))
    full = _rows(run, "no_search_window")
    np.testing.assert_array_equal(full, run["refs"]["no_search_window"])
    assert not np.array_equal(full, ts)


def test_channel_timesharded_conv_matches(run):
    """Noise and CFO off: the halo-convolved sharded channel equals the
    single-device linear convolution (its first T samples), complex64."""
    xs = run["need"]["channel_conv"][0]
    got = time_blocks(run["reports"], run["outputs"], "channel_conv", "out")
    ref = np.stack([np.convolve(x.astype(np.complex128),
                                jconstants.CHANNEL_TAPS)[:xs.shape[1]]
                    for x in xs])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_pipeline_with_sharded_channel_zero_errors(run):
    assert run["outputs"][0]["pipeline_24/errs"].tolist() == [0]
    assert all(o["pipeline_24/errs"].tolist() == [0] for o in run["outputs"])
    np.testing.assert_array_equal(_rows(run, "pipeline_24", "decoded")[:, 16:80],
                                  run["need"]["pipeline_24"][1])


@pytest.mark.parametrize("case", ["boundary", "qam16_cfo_matrix",
                                  "qam16_cfo_stream", *MIXED, "hamming_tail",
                                  "search_window"])
def test_timesharded_collectives_only_halo_and_reduce(run, case):
    """One right halo, three all_reduces (the keys' max, the sync chunks,
    the bytes) and no all_gather per decode; the fused Hamming tail adds no
    collective traffic."""
    for rep in run["reports"]:
        inv = rep["cases"][case]["counts"]
        assert inv["all_gather"]["calls"] == 0, inv
        assert inv["permute"]["calls"] == 1 and inv["all_reduce"]["calls"] == 3, inv
    if case == "hamming_tail":
        for rep in run["reports"]:
            assert rep["cases"]["hamming_tail"]["counts"] == \
                rep["cases"]["hamming_raw"]["counts"]
