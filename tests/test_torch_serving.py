"""The serving composition of config 5 (``ofdm_tpu_torch/io/serving.py``)
and the ``rx_stream`` app on the CPU, at 6 frames per buffer (config 5's
frame: a 24 x 24 id image, RS-coded to 765 bytes, QAM64 with guard bands,
2,560 samples), 2 distinct buffers (the second with CFO), 2 rounds and 2
buffers in flight.

Every image must come back exactly, in feed mode (a sample feed through a
pinned-ring upload), from buffers already on the device and from planar
captures; the serve step's payload rows must equal the JAX package's
``_first_sync`` + ``_extract_and_decode`` on the same buffer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu.config import DEFAULT_CONFIG as JCFG
from ofdm_tpu.phy import streaming as js
from ofdm_tpu_torch.apps import rx_stream
from ofdm_tpu_torch.core.transfer import Uploader, to_device_planar, to_host
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io import iqfile
from ofdm_tpu_torch.io.capture import Capture
from ofdm_tpu_torch.io.feed import SampleFeed, double_buffered
from ofdm_tpu_torch.io import serving
from ofdm_tpu_torch.io.serving import (encode_rows, serve, serve_step,
                                       synth_buffers)
from ofdm_tpu_torch.packets.colors import id_to_rgb

torch.set_num_threads(1)

N_FRAMES, ROUNDS, IN_FLIGHT = 6, 2, 2
T = serving.buffer_len(N_FRAMES)


@pytest.fixture(scope="module")
def buffers():
    """(2 complex64 buffers on the CPU, their pixels [2, 6, 576])."""
    return synth_buffers(2, N_FRAMES, device="cpu")


def _order():
    return [i % 2 for i in range(2 * ROUNDS)]


def _check(served, pixels):
    served = list(served)
    assert [s.index for s in served] == list(range(2 * ROUNDS))
    for s, b in zip(served, _order()):
        assert s.ok.all(), s.index
        np.testing.assert_array_equal(s.pixels, pixels[b])
        np.testing.assert_array_equal(
            s.rgb, id_to_rgb(pixels[b]).reshape(N_FRAMES, 24, 24, 3))
        assert s.latency_s > 0 and s.rs_s > 0 and s.colors_s > 0
    return served


def test_geometry_is_config_5():
    assert (serving.USER_BYTES, serving.PAYLOAD_LEN, serving.N_BLOCKS,
            serving.FLEN) == (576, 765, 22, 2560)
    assert serving.buffer_len() == 1_996_960


def test_encode_rows_is_encode_stream():
    pixels = np.random.default_rng(0).integers(0, 256, (5, 576), dtype=np.uint8)
    np.testing.assert_array_equal(
        encode_rows(pixels), np.stack([rs.encode_stream(p) for p in pixels]))


def test_synth_buffers(buffers):
    bufs, pixels = buffers
    assert pixels.shape == (2, 6, 576)
    assert all(b.shape == (T,) and b.dtype == torch.complex64 for b in bufs)
    again, _ = synth_buffers(2, N_FRAMES, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, bufs))


def test_device_resident_mode(buffers):
    bufs, pixels = buffers
    _check(serve((bufs[b] for b in _order()), N_FRAMES, in_flight=IN_FLIGHT),
           pixels)


def test_feed_mode(buffers):
    bufs, pixels = buffers
    host = [to_host(b) for b in bufs]
    with SampleFeed(host[b] for b in _order()) as feed:
        _check(serve(double_buffered(feed, Uploader("cpu")), N_FRAMES,
                     in_flight=IN_FLIGHT), pixels)


def test_planar_capture_mode(buffers, tmp_path):
    """Buffers written as fc32 files, read back through Capture.chunks and
    uploaded as planes: the same bytes as the complex buffers."""
    bufs, pixels = buffers
    paths = []
    for i, b in enumerate(bufs):
        paths.append(tmp_path / f"buf{i}.dat")
        iqfile.write_iq(paths[-1], to_host(b))

    def planes():
        for b in _order():
            with Capture(paths[b]) as cap:
                yield next(cap.chunks(T))

    with SampleFeed(planes()) as feed:
        served = _check(serve(double_buffered(feed, Uploader("cpu", planar=True)),
                              N_FRAMES, in_flight=IN_FLIGHT), pixels)
    for b, path in enumerate(paths):
        with Capture(path) as cap:
            p = to_device_planar(next(cap.chunks(T)), device="cpu")
        assert torch.equal(serve_step(p, N_FRAMES), serve_step(bufs[b], N_FRAMES))
    assert len(served) == 2 * ROUNDS


@pytest.mark.parametrize("b", [0, 1], ids=["clean", "cfo"])
def test_payload_rows_match_jax(buffers, b):
    bufs, pixels = buffers
    x = to_host(bufs[b])
    flen = serving.FLEN
    kw = dict(spacing=flen, need=N_FRAMES * flen + JCFG.sym_len, cfg=JCFG)
    s = jnp.asarray(x)
    first = jnp.maximum(js._first_sync(s, **kw), 0).astype(jnp.int32)
    out = js._extract_and_decode(
        s, first, n_frames=N_FRAMES, nb=serving.N_BLOCKS, flen=flen,
        guard_bands=True, modulation=ot.Modulation.QAM64, **kw)
    want = np.asarray(out)[:, 16:16 + serving.PAYLOAD_LEN]
    got = serve_step(torch.as_tensor(x), N_FRAMES)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    data, ok = rs.decode_payload_rows(want, serving.USER_BYTES)
    assert ok.all()
    np.testing.assert_array_equal(data, pixels[b])


def test_in_flight_must_be_positive(buffers):
    with pytest.raises(ValueError, match="in_flight"):
        list(serve(buffers[0], N_FRAMES, in_flight=0))


# --- the rx_stream app --------------------------------------------------------

APP = ["--buffers", "2", "--buffer-len", "32768", "--device", "cpu"]


@pytest.mark.parametrize("mode", [[], ["--continuous"],
                                  ["--continuous", "--scan-loop"]],
                         ids=["decode", "continuous", "scan-loop"])
def test_rx_stream(mode):
    assert rx_stream.main(APP + mode) == 0


def test_rx_stream_out_dir(tmp_path):
    pytest.importorskip("PIL")
    assert rx_stream.main(APP + ["--out-dir", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["frame_000.png", "frame_001.png"]


def test_rx_stream_files(tmp_path):
    """--files replays fc32 captures of the app's own frame."""
    import ofdm_tpu_torch as ott
    from ofdm_tpu_torch.io.feed import synthetic_captures
    from ofdm_tpu_torch.apps.common import seeded_image
    image = seeded_image(24, 24)
    frame = to_host(ott.encode(rs.encode_stream(image), guard_bands=True,
                               modulation=ott.Modulation.QPSK, device="cpu"))
    paths = []
    for i, buf in enumerate(synthetic_captures(2, 1, lambda i: frame, 20000,
                                               seed=3)):
        paths.append(str(tmp_path / f"cap{i}.dat"))
        iqfile.write_iq(paths[-1], buf)
    assert rx_stream.main(["--files", *paths, "--device", "cpu"]) == 0


def test_rx_stream_nothing_decoded_fails(tmp_path):
    path = tmp_path / "noise.dat"
    iqfile.write_iq(path, 0.01 * np.random.default_rng(0).standard_normal(20000))
    assert rx_stream.main(["--files", str(path), "--device", "cpu"]) == 1
