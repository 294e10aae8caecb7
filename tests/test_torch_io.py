"""Transfer, the sample feed, the capture reader and IQ files of the port
against ofdm_tpu's (``core/transfer.py``, ``io/feed.py``, ``io/capture.py``,
``io/iqfile.py``; mirrors tests/test_feed_transfer.py and
tests/test_capture.py).  Values are compared bitwise: every path here copies
samples or rounds them to float32 the same way.

The JAX package is imported only inside the tests that compare with it, so
the ``gpu`` tests at the end (the pinned ring, the copy stream, the async
fetch) also run on a host without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_io.py
"""

import ctypes
import shutil
import subprocess
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.core.transfer import (Uploader, fetch_async, padded_len,
                                          to_device, to_device_planar, to_host)
from ofdm_tpu_torch.io import capture as capture_mod
from ofdm_tpu_torch.io import iqfile
from ofdm_tpu_torch.io.capture import Capture
from ofdm_tpu_torch.io.feed import (SampleFeed, double_buffered, file_replay,
                                    synthetic_captures)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = partial(to_device, device="cpu")


def _jax():
    """ofdm_tpu's transfer module, imported only where a test compares."""
    from ofdm_tpu.core import transfer
    return transfer


# --- transfer ------------------------------------------------------------------

def test_complex_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    d = to_device(x, device="cpu")
    assert d.dtype == torch.complex128
    np.testing.assert_array_equal(to_host(d), x)
    np.testing.assert_array_equal(to_host(d), _jax().to_host(_jax().to_device(x)))


def test_real_passthrough():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(to_host(to_device(x, device="cpu")), x)


def test_numpy_input_unchanged():
    x = np.ones(5, np.complex128)
    assert to_host(x) is x


def test_dtype_override():
    x = np.ones(8, np.complex128)
    assert to_device(x, dtype=torch.complex64, device="cpu").dtype == torch.complex64
    assert to_device(np.arange(4), dtype=torch.float32,
                     device="cpu").dtype == torch.float32


def test_upload_is_a_copy():
    x = np.arange(6, dtype=np.complex64)
    d = to_device(x, device="cpu")
    x[:] = 0
    np.testing.assert_array_equal(to_host(d), np.arange(6, dtype=np.complex64))


def test_host_input_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: to_device(np.ones(3)),
                 lambda: to_device_planar(np.ones(3, np.complex64)),
                 lambda: Uploader()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("pad_to_tiles", [True, False])
@pytest.mark.parametrize("form", ["complex", "planes", "real", "batch"])
def test_to_device_planar_matches_jax(form, pad_to_tiles):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((3, 300)) + 1j * rng.standard_normal((3, 300))
    x = {"complex": z[0], "planes": (z[0].real.astype(np.float32),
                                     z[0].imag.astype(np.float32)),
         "real": z[0].real, "batch": z}[form]
    got = to_device_planar(x, pad_to_tiles=pad_to_tiles, device="cpu")
    want = np.asarray(_jax().to_device_planar(x, pad_to_tiles=pad_to_tiles))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape[-1] == padded_len(300, pad_to_tiles)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_device_planar_decode():
    """Planar upload (complex or plane-pair input) feeds
    decode_frame_planar byte-exactly, as it feeds the JAX package's."""
    import jax
    import jax.numpy as jnp

    import ofdm_tpu as ot
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (2, 120), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK,
                   dtype=jnp.complex64)
    rx = np.asarray(ot.channel(tx, snr=35.0, key=jax.random.key(1)))
    nb = ot.n_data_blocks(120, ot.Modulation.QPSK, True)
    kw = dict(n_blocks=nb, guard_bands=True)
    p = to_device_planar(rx, device="cpu")
    assert p.shape[-2] == 2 and p.shape[-1] % 128 == 0
    out = ott.decode_frame_planar(p, modulation=ott.Modulation.QPSK, **kw)
    np.testing.assert_array_equal(out[:, 16:16 + 120].numpy(), data)
    want = np.asarray(ot.decode_frame_planar(
        _jax().to_device_planar(rx), modulation=ot.Modulation.QPSK, **kw))
    np.testing.assert_array_equal(out.numpy(), want)
    p2 = to_device_planar((rx.real.astype(np.float32),
                           rx.imag.astype(np.float32)), device="cpu")
    assert torch.equal(ott.decode_frame_planar(
        p2, modulation=ott.Modulation.QPSK, **kw), out)


def test_planar_uploader_rejects_mismatched_planes():
    with pytest.raises(ValueError, match="differ in shape"):
        to_device_planar((np.zeros(4, np.float32), np.zeros(5, np.float32)),
                         device="cpu")


def test_fetch_async_on_the_cpu_is_a_copy():
    t = torch.arange(12, dtype=torch.uint8).reshape(3, 4)[:, 1:3]
    f = fetch_async(t)
    t.zero_()
    np.testing.assert_array_equal(
        f.result(), np.arange(12, dtype=np.uint8).reshape(3, 4)[:, 1:3])


# --- the feed ------------------------------------------------------------------

def test_backpressure_and_order():
    bufs = [np.full(10, i, np.complex64) for i in range(5)]
    with SampleFeed(iter(bufs), depth=1) as feed:
        got = [int(b[0].real) for b in feed]
    assert got == [0, 1, 2, 3, 4]


def test_producer_exception_propagates():
    def bad():
        yield np.zeros(4)
        raise RuntimeError("capture died")

    with pytest.raises(RuntimeError, match="capture died"):
        with SampleFeed(bad()) as feed:
            list(feed)


@pytest.mark.parametrize("upload", [CPU, Uploader("cpu"),
                                    Uploader("cpu", planar=True,
                                             pad_to_tiles=False)],
                         ids=["to_device", "uploader", "planar uploader"])
def test_double_buffered_yields_all_in_order(upload):
    bufs = [np.full(4, i + 1j, np.complex64) for i in range(4)]
    out = list(double_buffered(iter(bufs), upload))
    assert len(out) == 4
    for i, o in enumerate(out):
        if o.dim() == 2:                            # planar
            o = torch.complex(o[0], o[1])
        np.testing.assert_array_equal(to_host(o), bufs[i])


@pytest.mark.parametrize("upload", [CPU, Uploader("cpu")],
                         ids=["to_device", "uploader"])
def test_double_buffered_empty(upload):
    assert list(double_buffered([], upload)) == []


def test_synthetic_captures_match_jax():
    from ofdm_tpu.io import feed as jfeed
    frame = (np.arange(100) * (1 + 0.5j)).astype(np.complex64)
    got = list(synthetic_captures(3, 2, lambda i: frame * (i + 1), 1000, seed=1))
    want = list(jfeed.synthetic_captures(3, 2, lambda i: frame * (i + 1), 1000,
                                         seed=1))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64
        np.testing.assert_array_equal(g, w)
        assert np.abs(g).max() > 0.5


def test_file_replay_matches_jax(tmp_path):
    from ofdm_tpu.io import feed as jfeed
    rng = np.random.default_rng(4)
    paths = []
    for i in range(2):
        paths.append(tmp_path / f"c{i}.dat")
        iqfile.write_iq(paths[-1], rng.standard_normal(50)
                        + 1j * rng.standard_normal(50))
    got = list(file_replay(paths, dtype=np.complex64, loop=2))
    want = list(jfeed.file_replay(paths, dtype=np.complex64, loop=2))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- IQ files and the capture reader ------------------------------------------

@pytest.mark.parametrize("module", ["io/capture.py", "io/iqfile.py"])
def test_copies_are_byte_equal(module):
    assert (ROOT / "ofdm_tpu_torch" / module).read_bytes() == \
        (ROOT / "ofdm_tpu" / module).read_bytes()


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_sig_to_bytes_matches_jax(form):
    from ofdm_tpu.io import iqfile as jiq
    rng = np.random.default_rng(5)
    z = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    x = torch.as_tensor(z) if form == "tensor" else z
    got = iqfile.sig_to_bytes(x)
    assert got == jiq.sig_to_bytes(z)
    assert len(got) == 33 * 8
    np.testing.assert_array_equal(iqfile.bytes_to_sig(got), jiq.bytes_to_sig(got))


@pytest.fixture(scope="module")
def native_loader(tmp_path_factory):
    """native/iq_loader.cpp built with native/Makefile's flags into a
    temporary directory and declared as the capture module declares it."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build native/iq_loader.cpp")
    so = tmp_path_factory.mktemp("native") / "libiq_loader.so"
    subprocess.run([cxx, "-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                    "-fopenmp", "-shared", "-o", str(so),
                    str(ROOT / "native" / "iq_loader.cpp")], check=True,
                   capture_output=True, timeout=240)
    lib = ctypes.CDLL(str(so))
    lib.iq_open.restype = ctypes.c_void_p
    lib.iq_open.argtypes = [ctypes.c_char_p]
    lib.iq_n_samples.restype = ctypes.c_int64
    lib.iq_n_samples.argtypes = [ctypes.c_void_p]
    lib.iq_read_planar.restype = ctypes.c_int64
    lib.iq_read_planar.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.iq_close.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(params=["native", "memmap"])
def reader(request, monkeypatch):
    """The port's capture module on the native loader or on memmap; the JAX
    package's on memmap."""
    import ofdm_tpu.io.capture as jcap
    lib = request.getfixturevalue("native_loader") \
        if request.param == "native" else None
    monkeypatch.setattr(capture_mod, "_LIB", lib)
    monkeypatch.setattr(jcap, "_LIB", None)
    return jcap.Capture


@pytest.fixture
def cap_file(tmp_path):
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
           ).astype(np.complex64)
    p = tmp_path / "cap.dat"
    iqfile.write_iq(p, sig)
    return p, sig


def _equal_pairs(a, b):
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_capture_read_planar_matches_jax(reader, cap_file):
    p, sig = cap_file
    with Capture(p) as c, reader(p) as j:
        assert c.n_samples == j.n_samples == 5000
        re, im = c.read_planar(123, 77)
        np.testing.assert_array_equal(re + 1j * im, sig[123:200])
        _equal_pairs((re, im), j.read_planar(123, 77))
        eof = c.read_planar(4990, 100)             # EOF clip
        assert eof[0].size == 10
        _equal_pairs(eof, j.read_planar(4990, 100))


def test_capture_chunks_match_jax(reader, cap_file):
    p, sig = cap_file
    with Capture(p) as c, reader(p) as j:
        chunks = list(c.chunks(1024, overlap=79))
        want = list(j.chunks(1024, overlap=79))
    assert len(chunks) == len(want) == 5
    assert chunks[0][0].size == 1024 and chunks[1][0].size == 1024 + 79
    for g, w in zip(chunks, want):
        _equal_pairs(g, w)
    joined = np.concatenate([chunks[0][0] + 1j * chunks[0][1]]
                            + [(re + 1j * im)[79:] for re, im in chunks[1:]])
    np.testing.assert_array_equal(joined, sig)


def test_capture_missing_file(reader, tmp_path):
    with pytest.raises(OSError):
        Capture(tmp_path / "nope.dat")
    with pytest.raises(OSError):
        reader(tmp_path / "nope.dat")


def test_capture_planes_upload_planar(cap_file):
    """A capture's planes go through to_device_planar as they are."""
    p, sig = cap_file
    with Capture(p) as c:
        planes = to_device_planar(next(c.chunks(5000)), pad_to_tiles=False,
                                  device="cpu")
    assert torch.equal(torch.complex(planes[0], planes[1]), torch.as_tensor(sig))


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_pinned_ring_double_buffered(cuda):
    """Six buffers through a 2-slot pinned ring: each is used on the current
    stream right after it is yielded, while the next one copies; the ring
    stays 2 pinned slots on its own copy stream."""
    up = Uploader(cuda)
    rng = np.random.default_rng(1)
    bufs = [(rng.standard_normal(1 << 20) + 1j * rng.standard_normal(1 << 20)
             ).astype(np.complex64) * (i + 1) for i in range(6)]
    sums = [torch.view_as_real(b).sum(0) for b in double_buffered(iter(bufs), up)]
    torch.cuda.synchronize()
    for s, b in zip(sums, bufs):
        want = torch.view_as_real(torch.as_tensor(b)).double().sum(0)
        torch.testing.assert_close(s.cpu().double(), want, rtol=1e-4, atol=1e-2)
    assert len(sums) == 6 and len(up._host) == 2
    assert all(h.is_pinned() for h in up._host)
    assert up._stream != torch.cuda.current_stream(cuda)


@pytest.mark.gpu
def test_upload_values_and_layouts(cuda):
    rng = np.random.default_rng(2)
    z = (rng.standard_normal((2, 999)) + 1j * rng.standard_normal((2, 999)))
    d = to_device(z)
    assert d.device == cuda and d.dtype == torch.complex128
    np.testing.assert_array_equal(to_host(d), z)
    planes = to_device_planar(z.astype(np.complex64))
    want = to_device_planar(z.astype(np.complex64), device="cpu")
    assert planes.is_contiguous() and torch.equal(planes.cpu(), want)


@pytest.mark.gpu
def test_fetch_async(cuda):
    x = torch.arange(1 << 20, device=cuda, dtype=torch.int32).reshape(1024, 1024)
    y = (x * 3)[:, 100:900]              # a strided slice, as serving fetches
    f = fetch_async(y)
    got = f.result()
    np.testing.assert_array_equal(got, (np.arange(1 << 20, dtype=np.int32)
                                        .reshape(1024, 1024) * 3)[:, 100:900])
    assert f._host.is_pinned()


@pytest.mark.gpu
def test_upload_and_fetch_do_not_synchronize(cuda):
    up = Uploader(cuda)
    x = np.ones(1 << 16, np.complex64)
    up(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = up.start(x).wait() * 2
        f = fetch_async(y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(f.result(), 2 * x)
