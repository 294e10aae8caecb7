"""Stream decoding against ofdm_tpu on the same samples: every case of
tests/test_streaming.py that tests no TPU layout and no jit cache, and the
SNR ladder of tests/test_detection_thresholds.py, through both packages on
one complex64 stream made by the JAX package (4 frames x 96 B, QPSK, Hamming
coded).  Payloads, ok flags and positions must be equal.

Also: the reference faults the port does not copy (F1, rows past a short
stream's end; F8, the float32 window energy), the one it ports as it is
(F7, resync pinned to offset 0), and the plain version of the shared-stream
mode of the ``planar_align`` kernel (K3).  The kernel itself meets it in
test_torch_kernels.py's ``gpu`` tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu.config import DEFAULT_CONFIG as JCFG
from ofdm_tpu.fec import hamming as jhamming
from ofdm_tpu.phy import streaming as js
import ofdm_tpu_torch as ott
from ofdm_tpu_torch import DEFAULT_CONFIG
from ofdm_tpu_torch.fec import hamming
from ofdm_tpu_torch.kernels.align import planar_align
from ofdm_tpu_torch.phy import streaming as ts
from tests.test_torch_kernels import (NEED_S, OFFS_S, shared_stream_case,
                                      stream_forms)

torch.set_num_threads(1)

QPSK = ott.Modulation.QPSK
PLEN = 168                                   # coded_len(96, "hamming")
HAM = dict(payload_len=PLEN, fec="hamming", data_len=96)


@pytest.fixture(scope="module")
def frames():
    """tests/test_streaming.py's 4 Hamming-coded frames."""
    rng = np.random.default_rng(0)
    datas = np.stack([rng.integers(0, 256, 96, dtype=np.uint8) for _ in range(4)])
    coded = np.asarray(jhamming.encode(jnp.asarray(datas)))
    tx = np.asarray(ot.encode(coded, guard_bands=True,
                              modulation=ot.Modulation.QPSK,
                              dtype=jnp.complex128))
    return datas, tx


def _c64(x) -> np.ndarray:
    return np.asarray(x).astype(np.complex64)


def _regular(stream, **kw):
    """(JAX, port) results of decode_regular on the same stream; planar
    streams go to both as f32 [2, T]."""
    want = js.decode_regular(jnp.asarray(stream), modulation=ot.Modulation.QPSK,
                             **kw)
    got = ts.decode_regular(torch.as_tensor(stream), modulation=QPSK, **kw)
    return want, got


def _assert_same(want, got, datas=None):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if datas is not None:
        assert got[1].all()
        np.testing.assert_array_equal(got[0], datas)


def _burst_stream(tx, gaps, noise_seed=5):
    rng = np.random.default_rng(noise_seed)
    parts, positions, pos = [], [], 0
    for i, g in enumerate(gaps):
        parts.append(0.001 * (rng.standard_normal(g) + 1j * rng.standard_normal(g)))
        pos += g
        positions.append(pos)
        parts.append(tx[i])
        pos += tx.shape[1]
    return _c64(np.concatenate(parts)), positions


def _same_detections(want, got):
    assert len(got) == len(want)
    for (pw, dw, okw), (pg, dg, okg) in zip(want, got):
        assert (pg, okg) == (pw, okw)
        np.testing.assert_array_equal(dg, dw)


def test_coded_len():
    for n in (1, 96, 223, 500):
        for fec in (None, "hamming", "rs"):
            assert ts.coded_len(n, fec) == js.coded_len(n, fec)
    with pytest.raises(ValueError):
        ts.coded_len(96, "ldpc")


@pytest.mark.parametrize("resync", [True, False])
def test_decode_regular_back_to_back(frames, resync):
    datas, tx = frames
    want, got = _regular(_c64(tx.reshape(-1)), n_frames=4, spacing=tx.shape[1],
                         resync=resync, **HAM)
    _assert_same(want, got, datas)


@pytest.mark.parametrize("resync", [True, False])
def test_decode_regular_through_channel(frames, resync):
    datas, tx = frames
    spacing = tx.shape[1] + 200
    stream = np.zeros(4 * spacing + 100, np.complex128)
    for i in range(4):
        stream[i * spacing: i * spacing + tx.shape[1]] = tx[i]
    noisy = _c64(ot.channel(jnp.asarray(stream), snr=20.0, key=jax.random.key(2)))
    want, got = _regular(noisy, n_frames=4, spacing=spacing, resync=resync, **HAM)
    _assert_same(want, got, datas)


def test_decode_regular_presync_through_channel(frames):
    datas, tx = frames
    spacing = tx.shape[1]
    stream = np.zeros(4 * spacing + 300, np.complex128)
    for i in range(4):
        stream[123 + i * spacing: 123 + i * spacing + spacing] = tx[i]
    noisy = _c64(ot.channel(jnp.asarray(stream), snr=20.0, key=jax.random.key(9)))
    want, got = _regular(noisy, n_frames=4, spacing=spacing, resync=False, **HAM)
    _assert_same(want, got, datas)


@pytest.mark.parametrize("fec", [None, "rs"])
def test_decode_regular_host_fec(frames, fec):
    """fec=None and the host RS path (raw payload bytes, and RS's ok flags
    on frames that carry no RS code)."""
    _, tx = frames
    kw = dict(n_frames=4, spacing=tx.shape[1], payload_len=PLEN, fec=fec)
    want, got = _regular(_c64(tx.reshape(-1)), **kw)
    _assert_same(want, got)


def test_fused_hamming_matches_unfused(frames):
    """The device Hamming tail equals fec=None plus hamming.decode on the
    host, and corrects a single-bit error injected into frame 2."""
    datas, tx = frames
    coded = np.array(jhamming.encode(jnp.asarray(datas)))
    coded[2, 3] ^= 0x10
    tx2 = np.asarray(ot.encode(coded, guard_bands=True, modulation=ot.Modulation.QPSK,
                               dtype=jnp.complex128))
    stream = torch.as_tensor(_c64(tx2.reshape(-1)))
    kw = dict(n_frames=4, spacing=tx.shape[1], payload_len=PLEN, modulation=QPSK)
    fused, oks = ts.decode_regular(stream, fec="hamming", data_len=96, **kw)
    raw, _ = ts.decode_regular(stream, fec=None, **kw)
    unfused = hamming.decode(torch.as_tensor(raw), 96).numpy()
    assert oks.all()
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_array_equal(fused, datas)
    want = js.decode_regular(jnp.asarray(stream.numpy()), n_frames=4,
                             spacing=tx.shape[1], modulation=ot.Modulation.QPSK,
                             **HAM)
    _assert_same(want, (fused, oks))


def test_encode_hamming_matches_two_stage():
    data = np.random.default_rng(9).integers(0, 256, (3, 96), dtype=np.uint8)
    kw = dict(guard_bands=True, modulation=QPSK, device="cpu")
    fused = ott.encode_hamming(data, **kw)
    two_stage = ott.encode(hamming.encode(torch.as_tensor(data)), **kw)
    assert torch.equal(fused, two_stage)
    want = np.asarray(ot.encode_hamming(jnp.asarray(data), guard_bands=True,
                                        modulation=ot.Modulation.QPSK))
    np.testing.assert_allclose(fused.numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def planar_case(frames):
    """tests/test_streaming.py's planar stream: 4 frames, spacing flen + 160,
    each at +37, through the channel at SNR 25."""
    _, tx = frames
    spacing = tx.shape[1] + 160
    stream = np.zeros(4 * spacing + 100, np.complex128)
    for i in range(4):
        stream[i * spacing + 37: i * spacing + 37 + tx.shape[1]] = tx[i]
    noisy = _c64(ot.channel(jnp.asarray(stream), snr=25.0, key=jax.random.key(7)))
    return noisy, np.stack([noisy.real, noisy.imag]), spacing


@pytest.mark.parametrize("resync", [True, False])
def test_decode_regular_planar_stream(frames, planar_case, resync):
    datas, _ = frames
    cplx, planar, spacing = planar_case
    kw = dict(n_frames=4, spacing=spacing, resync=resync, **HAM)
    want, got = _regular(planar, **kw)
    _assert_same(want, got, datas)
    np.testing.assert_array_equal(
        ts.decode_regular(torch.as_tensor(cplx), modulation=QPSK, **kw)[0], got[0])


@pytest.mark.parametrize("handoff", ["planar", "complex", "split"])
def test_decode_regular_planar_handoffs(frames, planar_case, handoff):
    """Every presync handoff, on contiguous planes and on the strided view
    torch.view_as_real(x).t(), equals JAX's."""
    datas, _ = frames
    cplx, planar, spacing = planar_case
    kw = dict(n_frames=4, spacing=spacing, resync=False, planar_handoff=handoff,
              **HAM)
    want, got = _regular(planar, **kw)
    _assert_same(want, got, datas)
    view = torch.view_as_real(torch.as_tensor(cplx)).t()
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        ts.decode_regular(view, modulation=QPSK, **kw)[0], got[0])


def test_first_sync_false_peak_regression():
    """tests/test_streaming.py's draw whose QPSK body out-correlates the
    locking block under raw |c|^2: the normalized filter returns -1 (the
    lag-0 quirk) on both stream forms, and the buffer decodes."""
    rng = np.random.default_rng(1)
    _ = rng.integers(0, 256, (4, 48), dtype=np.uint8)
    user = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    frames_ = np.asarray(ot.encode_hamming(jnp.asarray(user), guard_bands=True,
                                           modulation=ot.Modulation.QPSK))
    spacing = frames_.shape[-1]
    s = torch.as_tensor(_c64(frames_.reshape(-1)))
    assert int(ts._first_sync(s, spacing=spacing, cfg=DEFAULT_CONFIG)) == -1
    sp = torch.stack([s.real, s.imag])
    assert int(ts._first_sync_planar(sp, spacing=spacing, cfg=DEFAULT_CONFIG)) == -1
    p, ok = ts.decode_regular(s, n_frames=4, spacing=spacing,
                              payload_len=ts.coded_len(64, "hamming"),
                              modulation=QPSK, fec="hamming", data_len=64)
    assert ok.all()
    np.testing.assert_array_equal(p, user)


def test_decode_regular_short_buffer_f1(frames):
    """ADVICE.md's F1 repro: spacing flen+40, first frame at 500, the buffer
    ending at the last frame.  The JAX package's dynamic slice clamps its
    start and decodes 0/3; the port's rows read zeros past the end: 3/3."""
    datas, tx = frames
    flen = tx.shape[1]
    spacing, first = flen + 40, 500
    stream = np.zeros(first + 2 * spacing + flen, np.complex64)
    for i in range(3):
        stream[first + i * spacing: first + i * spacing + flen] = tx[i]
    kw = dict(n_frames=3, spacing=spacing, resync=False, **HAM)
    want, got = _regular(stream, **kw)
    assert int((want[0] == datas[:3]).all(axis=1).sum()) == 0   # reference fault
    np.testing.assert_array_equal(got[0], datas[:3])
    for planar in (False, True):
        x = torch.as_tensor(stream)
        x = torch.stack([x.real, x.imag]) if planar else x
        for resync in (False, True):
            p, _ = ts.decode_regular(x, modulation=QPSK, **dict(kw, resync=resync))
            np.testing.assert_array_equal(p, datas[:3])


def test_decode_regular_quiet_gaps_f8(frames):
    """F8: noise 1e-4 in the 200-sample gaps between clean frames.  The JAX
    package's float32 window energy reads 0 in every gap, so its global sync
    lands there and no frame decodes; the port's float64 running sum keeps
    the true peak."""
    datas, tx = frames
    flen = tx.shape[1]
    spacing = flen + 200
    rng = np.random.default_rng(8)
    stream = 1e-4 * (rng.standard_normal(4 * spacing + 80)
                     + 1j * rng.standard_normal(4 * spacing + 80))
    for i in range(4):
        stream[i * spacing: i * spacing + flen] = tx[i]
    stream = _c64(stream)
    want, got = _regular(stream, n_frames=4, spacing=spacing, resync=False, **HAM)
    assert int((want[0] == datas).all(axis=1).sum()) == 0       # reference fault
    np.testing.assert_array_equal(got[0], datas)


def test_resync_is_presync_f7(frames):
    """F7: every resync row is exactly one frame long, so its offset clips
    to 0 and resync decodes what presync decodes, drift or not.  With 3
    samples of drift per frame the port's resync bytes equal JAX's."""
    datas, tx = frames
    flen = tx.shape[1]
    spacing = flen + 100
    stream = np.zeros(4 * spacing + 200, np.complex128)
    for i in range(4):
        stream[i * spacing + 3 * i: i * spacing + 3 * i + flen] = tx[i]
    noisy = _c64(ot.channel(jnp.asarray(stream), snr=25.0, key=jax.random.key(4)))
    kw = dict(n_frames=4, spacing=spacing, **HAM)
    want, got = _regular(noisy, resync=True, **kw)
    _assert_same(want, got)
    presync = ts.decode_regular(torch.as_tensor(noisy), modulation=QPSK,
                                resync=False, **kw)
    np.testing.assert_array_equal(presync[0], got[0])


@pytest.mark.parametrize("bad", [
    dict(planar_handoff="nope"), dict(fec="ldpc"), dict(spacing=100)])
def test_decode_regular_rejects(frames, bad):
    _, tx = frames
    kw = dict(dict(n_frames=4, spacing=tx.shape[1], **HAM), **bad)
    with pytest.raises(ValueError):
        ts.decode_regular(torch.as_tensor(_c64(tx.reshape(-1))), modulation=QPSK,
                          **kw)


def test_decode_regular_rejects_tiled_stream(frames):
    _, tx = frames
    tiled = torch.zeros((2, 40, 128))
    with pytest.raises(ValueError, match="pre-tiled"):
        ts.decode_regular(tiled, n_frames=1, spacing=tx.shape[1], modulation=QPSK,
                          **HAM)


def test_host_input_goes_to_cuda(frames):
    """An array carries no device: it goes to CUDA, and where there is none
    the call raises unless it names the CPU."""
    datas, tx = frames
    stream = _c64(tx.reshape(-1))
    kw = dict(n_frames=4, spacing=tx.shape[1], modulation=QPSK, **HAM)
    p, _ = ts.decode_regular(stream, device="cpu", **kw)
    np.testing.assert_array_equal(p, datas)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ts.decode_regular(stream, **kw)


@pytest.fixture(scope="module")
def burst_case(frames):
    datas, tx = frames
    stream, positions = _burst_stream(tx, [700, 1500, 300, 2200])
    kw = dict(acquisition=4096, **HAM)
    want_burst = js.decode_burst(jnp.asarray(stream), modulation=ot.Modulation.QPSK,
                                 **kw)
    want_cont = list(js.decode_continuous(jnp.asarray(stream),
                                          modulation=ot.Modulation.QPSK, **kw))
    return datas, stream, positions, want_burst, want_cont


def test_decode_continuous_irregular_gaps(burst_case):
    datas, stream, positions, _, want = burst_case
    got = list(ts.decode_continuous(torch.as_tensor(stream), modulation=QPSK,
                                    acquisition=4096, **HAM))
    _same_detections(want, got)
    assert len(got) == 4
    for i, (p, d, ok) in enumerate(got):
        assert ok and abs(p - positions[i]) <= 2
        np.testing.assert_array_equal(d, datas[i])


def test_decode_burst_matches_continuous(burst_case):
    datas, stream, positions, want, want_cont = burst_case
    got = ts.decode_burst(torch.as_tensor(stream), modulation=QPSK,
                          acquisition=4096, **HAM)
    _same_detections(want, got)
    _same_detections(want_cont, got)
    for i, (p, d, ok) in enumerate(got):
        assert ok and abs(p - positions[i]) <= 2
        np.testing.assert_array_equal(d, datas[i])


def test_decode_continuous_max_frames(frames):
    _, tx = frames
    stream = _c64(tx.reshape(-1))
    want = list(js.decode_continuous(jnp.asarray(stream), modulation=ot.Modulation.QPSK,
                                     max_frames=2, **HAM))
    got = list(ts.decode_continuous(torch.as_tensor(stream), modulation=QPSK,
                                    max_frames=2, **HAM))
    _same_detections(want, got)
    assert len(got) == 2


def test_decode_burst_clean_positions(frames):
    datas, tx = frames
    positions = [523, 523 + tx.shape[1] + 977]
    stream = np.zeros(positions[-1] + tx.shape[1] + 401, np.complex64)
    for i, p in enumerate(positions):
        stream[p: p + tx.shape[1]] = tx[i]
    kw = dict(acquisition=2048, **HAM)
    want = js.decode_burst(jnp.asarray(stream), modulation=ot.Modulation.QPSK, **kw)
    got = ts.decode_burst(torch.as_tensor(stream), modulation=QPSK, **kw)
    _same_detections(want, got)
    assert len(got) == 2
    for i, (p, d, ok) in enumerate(got):
        assert ok and abs(p - positions[i]) <= 1
        np.testing.assert_array_equal(d, datas[i])


def test_decode_burst_empty_and_max(frames):
    _, tx = frames
    noise = _c64(0.001 * np.random.default_rng(0).standard_normal(40000))
    assert ts.decode_burst(torch.as_tensor(noise), modulation=QPSK, **HAM) == []
    assert js.decode_burst(jnp.asarray(noise), modulation=ot.Modulation.QPSK,
                           **HAM) == []
    stream = _c64(tx.reshape(-1))
    want = js.decode_burst(jnp.asarray(stream), modulation=ot.Modulation.QPSK,
                           max_frames=2, **HAM)
    got = ts.decode_burst(torch.as_tensor(stream), modulation=QPSK, max_frames=2,
                          **HAM)
    _same_detections(want, got)
    assert len(got) == 2


@pytest.mark.parametrize("fec", ["hamming", None, "rs"])
def test_decode_burst_through_channel(frames, fec):
    """Multipath + AWGN + CFO; with fec=None and "rs" the raw payload and
    RS's flags go through the host FEC path."""
    datas, tx = frames
    parts = []
    for i, g in enumerate([900, 1200, 400, 1800]):
        parts += [np.zeros(g, tx.dtype), tx[i]]
    noisy = _c64(ot.channel(jnp.asarray(np.concatenate(parts)), snr=25.0,
                            timing_error=True, key=jax.random.key(5)))
    kw = dict(payload_len=PLEN, fec=fec, data_len=96 if fec == "hamming" else None)
    want = js.decode_burst(jnp.asarray(noisy), modulation=ot.Modulation.QPSK, **kw)
    got = ts.decode_burst(torch.as_tensor(noisy), modulation=QPSK, **kw)
    _same_detections(want, got)
    assert len(got) == 4
    if fec == "hamming":
        for i, (_, d, ok) in enumerate(got):
            assert ok
            np.testing.assert_array_equal(d, datas[i])


# --- tests/test_detection_thresholds.py ------------------------------------

@pytest.fixture(scope="module")
def frame64():
    data = np.random.default_rng(11).integers(0, 256, 64, dtype=np.uint8)
    tx = np.asarray(ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK,
                              dtype=jnp.complex128))
    return data, tx


def _noisy_stream(rng, tx, offsets, t, snr_db):
    n_var = np.mean(np.abs(tx) ** 2) / 10 ** (snr_db / 10.0)
    s = np.sqrt(n_var / 2) * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    for off in offsets:
        s[off:off + tx.shape[-1]] += tx
    return _c64(s)


def _both_burst(stream):
    kw = dict(payload_len=64, guard_bands=True)
    want = js.decode_burst(jnp.asarray(stream), modulation=ot.Modulation.QPSK, **kw)
    got = ts.decode_burst(torch.as_tensor(stream), modulation=QPSK, **kw)
    _same_detections(want, got)
    return got


def _both_continuous(stream):
    kw = dict(payload_len=64, guard_bands=True)
    want = list(js.decode_continuous(jnp.asarray(stream),
                                     modulation=ot.Modulation.QPSK, **kw))
    got = list(ts.decode_continuous(torch.as_tensor(stream), modulation=QPSK, **kw))
    _same_detections(want, got)
    return got


@pytest.mark.parametrize("snr_db", [0.0, 5.0, 10.0, 30.0])
def test_burst_gate_detects_down_the_snr_ladder(frame64, snr_db):
    data, tx = frame64
    rng = np.random.default_rng(int(snr_db) + 3)
    found = _both_burst(_noisy_stream(rng, tx, [500, 9000], 16384, snr_db))
    assert len(found) == 2
    if snr_db >= 30.0:
        for _, p, _ in found:
            np.testing.assert_array_equal(p, data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burst_gate_no_false_positives_on_noise(frame64, seed):
    _, tx = frame64
    rng = np.random.default_rng(100 + seed)
    assert _both_burst(_noisy_stream(rng, 0 * tx, [], 16384, 0.0)) == []


def test_burst_gate_margin_at_design_point(frame64):
    _, tx = frame64
    rng = np.random.default_rng(42)
    flen = tx.shape[-1]
    for offsets, check in (([1000], lambda r: r.max() > 0.4),
                           ([], lambda r: r.max() < 0.2)):
        stream = _noisy_stream(rng, tx if offsets else 0 * tx, offsets,
                               2 * flen + 2048, 0.0)
        off_j, rho_j = js._scan_windows(jnp.asarray(stream), n_win=2, stride=flen,
                                        cfg=JCFG)
        off, rho = ts._scan_windows(torch.as_tensor(stream), n_win=2, stride=flen,
                                    cfg=DEFAULT_CONFIG)
        np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
        np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=1e-4)
        assert check(rho.numpy())


@pytest.mark.parametrize("snr_db", [0.0, 5.0, 30.0])
def test_continuous_gate_detects(frame64, snr_db):
    _, tx = frame64
    rng = np.random.default_rng(int(snr_db) + 7)
    assert len(_both_continuous(_noisy_stream(rng, tx, [700], 12288, snr_db))) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_gate_no_false_positives_on_noise(frame64, seed):
    _, tx = frame64
    rng = np.random.default_rng(200 + seed)
    assert _both_continuous(_noisy_stream(rng, 0 * tx, [], 12288, 0.0)) == []


# --- K3's shared-stream mode ------------------------------------------------

def _np_rows(stream: np.ndarray, offs, need) -> np.ndarray:
    padded = np.concatenate([stream, np.zeros(max(offs) + need, stream.dtype)])
    return np.stack([padded[o:o + need] for o in offs])


@pytest.fixture(scope="module")
def shared_stream():
    return shared_stream_case()


@pytest.mark.parametrize("form", ["complex", "planar", "planar strided"])
@pytest.mark.parametrize("planar", [False, True])
def test_planar_align_shared_stream_plain(shared_stream, form, planar):
    want = _np_rows(shared_stream, OFFS_S, NEED_S)
    x = stream_forms(torch.as_tensor(shared_stream))[form]
    before = planar_align.launches
    for dtype in (torch.int32, torch.int64):
        got = planar_align(x, torch.tensor(OFFS_S, dtype=dtype), NEED_S,
                           planar=planar)
        if planar:
            assert got.shape == (len(OFFS_S), 2, NEED_S)
            got = torch.complex(got[:, 0], got[:, 1])
        np.testing.assert_array_equal(got.numpy(), want)
    assert planar_align.launches == before


@pytest.mark.parametrize("bad", [
    lambda s: planar_align(s, torch.tensor([0, -1]), 10),            # negative
    lambda s: planar_align(s, torch.tensor([[0]]), 10),              # not [R]
    lambda s: planar_align(s, torch.tensor([0.0]), 10),              # not int
    lambda s: planar_align(s, torch.tensor([0]), 0),                 # need 0
    lambda s: planar_align(s[:0], torch.tensor([0]), 10),            # T = 0
    lambda s: planar_align(s.to(torch.complex128), torch.tensor([0]), 10),
])
def test_planar_align_shared_stream_rejects(shared_stream, bad):
    with pytest.raises(ValueError):
        bad(torch.as_tensor(shared_stream))
