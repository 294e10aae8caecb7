"""The port's bench, ``python -m ofdm_tpu_torch.bench``, on the CPU.

The whole command runs in a subprocess in which importing jax fails, from
a copy of ``ofdm_tpu_torch/`` and ``native/`` in a temporary directory (the
command builds the RS codec there), at a few rows, frames and buffers with
``--device cpu``; its last line is checked key by key: every gate at 0, the
``n`` of every timer, no device metric from a CPU run.  Without
``--device`` the command must fail on a host without a card, naming CUDA.
``core.native.build``, which the command calls, builds and loads both host
libraries in a fresh copy.  Seed 0 must draw ``bench.py``'s payload bytes.
The slice is held against the JAX package on the same numpy inputs: the
headline step, config 4's step and one serving buffer's payload slice.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofdm_tpu as ot
from ofdm_tpu.config import DEFAULT_CONFIG as JCFG
from ofdm_tpu.phy import streaming as js
from ofdm_tpu_torch import bench
from ofdm_tpu_torch.io import serving

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZES = ["--batch", "4", "--payload", "64", "--ham-frames", "2",
         "--srv-frames", "2", "--srv-distinct", "2", "--srv-rounds", "2",
         "--steps", "11"]
STEPS, BUFFERS = 11, 4
RUN = """
import runpy, sys
sys.modules["jax"] = None              # any attempt to import jax now fails
sys.modules["ofdm_tpu"] = None
sys.argv = ["bench", *sys.argv[1:]]
runpy.run_module("ofdm_tpu_torch.bench", run_name="__main__")
"""


def _run(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", RUN, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the package and native/ (sources only)."""
    root = tmp_path_factory.mktemp("bench")
    ignore = shutil.ignore_patterns("__pycache__", "*.so")
    for name in ("ofdm_tpu_torch", "native"):
        shutil.copytree(ROOT / name, root / name, ignore=ignore)
    return root


@pytest.fixture(scope="module")
def line(checkout):
    proc = _run(checkout, "--device", "cpu", *SIZES)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _at(line, path):
    for key in path:
        line = line[key]
    return line


def test_line_layout(line):
    assert (line["metric"], line["unit"], line["seed"]) == \
        ("samples/s (64QAM rx chain)", "samples/s", 0)
    assert line["device"] == {"platform": "cpu", "name": None,
                              "power_limit": None, "count": 1}
    d = line["detail"]
    assert {"batch", "frame_samples", "payload_bytes", "byte_errors_clean_batch",
            "ms_per_step", "blocking_latency_ms", "planar_input", "configs",
            "idle_share", "top_device_items", "launches",
            "peak_memory_bytes"} <= set(d)
    assert (d["batch"], d["frame_samples"], d["payload_bytes"]) == (4, 1120, 64)
    assert line["value"] == d["samples_per_s"] > 0
    assert set(d["configs"]) == {"hamming_streaming", "serving"}
    ham = d["configs"]["hamming_streaming"]["detail"]
    assert (ham["n_frames"], ham["frame_samples"], ham["data_bytes"],
            ham["wire_bytes"], ham["stream_samples"]) == (2, 19040, 4680, 8190,
                                                          2 * 19040 + 80)
    srv = d["configs"]["serving"]["detail"]
    assert (srv["frames_per_buffer"], srv["samples_per_buffer"], srv["buffers"],
            srv["distinct_buffers"], srv["in_flight"]) == \
        (2, serving.buffer_len(2), BUFFERS, 2, 4)
    assert srv["rs_native"] is True
    codec = srv["rs_codec"]
    assert set(codec) == {"openmp", "omp_num_threads", "cpu_count",
                          "built_now_with"}
    assert codec["omp_num_threads"] == "1" and codec["cpu_count"] > 0
    # the copy had no library: the command compiled it, and says with what
    assert "-O3" in codec["built_now_with"]
    assert codec["openmp"] == ("-fopenmp" in codec["built_now_with"])
    assert srv["payload_slice_bytes"] == 2 * serving.PAYLOAD_LEN


GATES = [("detail", "byte_errors_clean_batch"),
         ("detail", "planar_input", "byte_errors_clean_batch")]
GATES += [("detail", "configs", "hamming_streaming", "detail", *p, "user_byte_errors")
          for p in [(), ("planar_input",)]]
GATES += [("detail", "configs", "serving", "detail", mode, gate)
          for mode in ("d2h", "device_resident", "planar")
          for gate in ("payload_byte_errors", "image_errors", "rs_failures")]


@pytest.mark.parametrize("path", GATES, ids=lambda p: ".".join(p[1:]))
def test_gate_is_zero(line, path):
    assert _at(line, path) == 0


TIMERS = [(("detail", "ms_per_step"), STEPS),
          (("detail", "planar_input", "ms_per_step"), STEPS),
          (("detail", "blocking_latency_ms"), bench.LATENCY_CALLS)]
TIMERS += [(("detail", "configs", "hamming_streaming", "detail", *p,
             "ms_per_step"), STEPS) for p in [(), ("planar_input",)]]
TIMERS += [(("detail", "configs", "serving", "detail", *p), BUFFERS)
           for p in [("d2h", "latency_ms"), ("device_resident", "ms_per_step"),
                     ("planar", "latency_ms")]]


@pytest.mark.parametrize("path,n", TIMERS, ids=lambda p: ".".join(p[1:])
                         if isinstance(p, tuple) else str(p))
def test_timer(line, path, n):
    """Every timer gives its n and median; a p9 where it has 11 samples."""
    t = _at(line, path)
    assert t["n"] == n and t["median_ms"] > 0
    assert ("p9_ms" in t) == (n == STEPS)
    assert set(t) - {"n", "median_ms", "p9_ms", "wall_ms", "mean_ms"} == set()


def test_cpu_run_reports_no_device_metric(line):
    """A CPU run names no card and reports no device time, idle share,
    device memory or kernel launch (the wrappers count CUDA launches)."""
    d = line["detail"]
    ham = d["configs"]["hamming_streaming"]["detail"]
    srv = d["configs"]["serving"]["detail"]
    for part in (d, d["planar_input"], ham, ham["planar_input"], srv["d2h"],
                 srv["device_resident"], srv["planar"]):
        assert part["idle_share"] is None and part["launches"] == {}
    for part in (d, d["planar_input"], ham, ham["planar_input"], srv):
        assert part["device_busy_ms"] is None and part["top_device_items"] == []
    assert d["peak_memory_bytes"] is None and ham["peak_memory_bytes"] is None
    assert srv["peak_memory_bytes"] is None and d["kernel_build_s"] is None


def test_only_headline(checkout):
    proc = _run(checkout, "--device", "cpu", "--only", "headline", "--seed", "1",
                *SIZES)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["seed"] == 1 and out["detail"]["configs"] == {}
    assert out["detail"]["byte_errors_clean_batch"] == 0


def test_default_device_needs_cuda(checkout):
    """Without --device the command runs on CUDA, which this host lacks: it
    fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs")
    proc = _run(checkout, *SIZES)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def _broken(checkout: Path, tmp_path: Path, module: str, old: str,
            new: str) -> Path:
    """A copy of the checkout with ``old`` replaced by ``new`` in
    ``module`` (a path under ofdm_tpu_torch/)."""
    broken = tmp_path / "broken"
    for name in ("ofdm_tpu_torch", "native"):
        shutil.copytree(checkout / name, broken / name)
    path = broken / "ofdm_tpu_torch" / module
    src = path.read_text()
    assert old in src
    path.write_text(src.replace(old, new, 1))
    return broken


def test_a_failed_gate_prints_no_number(checkout, tmp_path):
    """The same command with a decoder that loses one byte exits non-zero
    before it prints anything."""
    hook = "def decode_frame(samples"
    broken = _broken(checkout, tmp_path, "phy/rx.py", hook,
                     "def _decode_frame(samples")
    rx = broken / "ofdm_tpu_torch" / "phy" / "rx.py"
    rx.write_text(rx.read_text() + (
        "\n\ndef decode_frame(samples, **kw):\n"
        "    out = _decode_frame(samples, **kw).clone()\n"
        "    out[0, 20] ^= 1\n"
        "    return out\n"))
    proc = _run(broken, "--device", "cpu", "--only", "headline", *SIZES)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "GateError" in proc.stderr and "1 payload byte errors" in proc.stderr


def test_serving_gate_sees_what_rs_corrects(checkout, tmp_path):
    """A serve step that gets one RS code byte wrong still gives every
    image and RS's ok, since RS(255,223) corrects it; the bench's payload
    gate fails all the same."""
    old = "    return out[:, HEADER_LEN:HEADER_LEN + PAYLOAD_LEN]\n"
    broken = _broken(checkout, tmp_path, "io/serving.py", old, (
        "    out = out[:, HEADER_LEN:HEADER_LEN + PAYLOAD_LEN].clone()\n"
        "    out[0, 5] ^= 1\n"
        "    return out\n"))
    proc = _run(broken, "--device", "cpu", *SIZES)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "GateError" in proc.stderr
    assert ("1 payload byte errors, 0 images differ, RS failed on 0 frames"
            in proc.stderr)


NATIVE = """
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io import capture
from ofdm_tpu_torch.core import native
assert rs._LIB is None and capture._LIB is None   # nothing built at import
seconds, flags = native.build()
assert flags and rs._LIB is not None and capture._LIB is not None
assert native.build()[1] == []                      # up to date: no compile
coded = rs.encode_stream(bytes(range(100)))
assert rs.decode_stream(coded)[1]
print("ok")
"""


def test_native_build_loads_both_libraries(tmp_path):
    """core.native.build compiles native/ into a checkout that has no
    library, reloads the RS and capture copies onto them, and compiles
    nothing the second time."""
    shutil.copytree(ROOT / "ofdm_tpu_torch", tmp_path / "ofdm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", NATIVE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    assert sorted(p.name for p in (tmp_path / "native").glob("*.so")) == \
        ["libiq_loader.so", "librs_codec.so"]


# --- the workloads ------------------------------------------------------------

def test_seed_0_draws_bench_py_payloads():
    """bench.py:120-123 and :274-277 draw from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 256, (256, 8192), dtype=np.uint8) for _ in range(4)]
    got = bench.headline_payloads(0)
    assert len(got) == 4 and all(np.array_equal(a, b) for a, b in zip(got, want))
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 256, (256, 4680), dtype=np.uint8) for _ in range(2)]
    got = bench.hamming_payloads(0)
    assert len(got) == 2 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_serving_pixels_follow_the_seed():
    """synth_buffers draws its pixels from default_rng(SEED + seed_offset)
    (SEED = 5, bench.py:422-424's, at the default offset 0); other offsets
    give other buffers."""
    bufs, pixels = serving.synth_buffers(2, 2, device="cpu")
    same, same_px = serving.synth_buffers(2, 2, seed_offset=0, device="cpu")
    assert np.array_equal(pixels, np.random.default_rng(5).integers(
        0, 256, (2, 2, serving.USER_BYTES), dtype=np.uint8))
    assert np.array_equal(pixels, same_px)
    assert all(torch.equal(a, b) for a, b in zip(bufs, same))
    other, other_px = serving.synth_buffers(2, 2, seed_offset=1, device="cpu")
    assert np.array_equal(other_px, np.random.default_rng(6).integers(
        0, 256, (2, 2, serving.USER_BYTES), dtype=np.uint8))
    assert not torch.equal(other[0], bufs[0])


@pytest.mark.parametrize("n,q", [(11, 9), (30, 66), (100, 90)])
def test_tail_percentile(n, q):
    """The highest whole percentile whose nearest-rank value has at least 10
    of the n samples beyond it."""
    assert bench.tail_percentile(n) == q
    times = list(np.random.default_rng(n).permutation(n) + 1.0)
    s = bench.summary(times)
    assert s["n"] == n and s["median_ms"] == (n + 1) / 2
    assert sum(t > s[f"p{q}_ms"] for t in times) >= 10
    assert -(-(q + 1) * n // 100) > n - 10       # q + 1 would leave fewer


def test_no_tail_below_11_samples():
    assert bench.tail_percentile(10) is None
    assert set(bench.summary([3.0, 1.0, 2.0])) == {"n", "median_ms"}


# --- the slice against the JAX package ----------------------------------------

@pytest.fixture(scope="module")
def headline():
    return bench.headline_workload(0, 8, 64, torch.device("cpu"))


@pytest.mark.parametrize("i", range(bench.N_INPUTS),
                         ids=["clean", "cfo1", "cfo2", "cfo3"])
def test_headline_step_matches_jax(headline, i):
    """decode_frame and decode_frame_planar on the bench's batches give
    JAX's decode_frame bytes on every row JAX decodes exactly (all rows of
    the clean batch; fault F5 elsewhere)."""
    datas, rxs, nb = headline
    kw = dict(n_blocks=nb, guard_bands=True, modulation=ot.Modulation.QAM64)
    want = np.asarray(ot.decode_frame(jnp.asarray(rxs[i].numpy()), **kw))
    good = (want[:, 16:16 + 64] == datas[i]).all(axis=1)
    assert good.all() if i == 0 else good.sum() >= len(good) // 2
    kw["modulation"] = bench.MOD
    planes = torch.stack([rxs[i].real, rxs[i].imag], dim=1).contiguous()
    for got in (bench.decode_frame(rxs[i], **kw),
                bench.decode_frame_planar(planes, **kw)):
        np.testing.assert_array_equal(got.numpy()[good], want[good])


@pytest.fixture(scope="module")
def hamming():
    return bench.hamming_workload(0, 2, torch.device("cpu"))


@pytest.mark.parametrize("i", range(bench.HAM_STREAMS))
def test_hamming_step_matches_jax(hamming, i):
    """Config 4's step on the complex and the planar stream gives JAX's
    decode_regular(resync=False, fec="hamming") user bytes, the sent ones."""
    datas, streams = hamming
    plen, _, flen = bench.hamming_geometry()
    want, ok = js.decode_regular(
        jnp.asarray(streams[i].numpy()), n_frames=2, spacing=flen,
        payload_len=plen, guard_bands=True, modulation=ot.Modulation.QAM64,
        fec="hamming", data_len=bench.HAM_DATA_BYTES, resync=False)
    want = np.asarray(want)
    assert np.asarray(ok).all() and np.array_equal(want, datas[i])
    s = streams[i]
    for x in (s, torch.stack([s.real, s.imag])):
        got, got_ok = bench.hamming_step(x, 2)
        assert got_ok.all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [0, 1], ids=["clean", "cfo"])
def test_serving_slice_matches_jax(b):
    """One serving buffer of the bench (seed 0) through serve_step gives
    JAX's _first_sync + _extract_and_decode payload slice (bench.py:441-452),
    which RS-decodes to the sent pixels."""
    bufs, pixels = serving.synth_buffers(2, 2, device="cpu")
    flen = serving.FLEN
    kw = dict(spacing=flen, need=2 * flen + JCFG.sym_len, cfg=JCFG)
    s = jnp.asarray(bufs[b].numpy())
    first = jnp.maximum(js._first_sync(s, **kw), 0).astype(jnp.int32)
    out = js._extract_and_decode(
        s, first, n_frames=2, nb=serving.N_BLOCKS, flen=flen, guard_bands=True,
        modulation=ot.Modulation.QAM64, **kw)
    want = np.asarray(out)[:, 16:16 + serving.PAYLOAD_LEN]
    np.testing.assert_array_equal(serving.serve_step(bufs[b], 2).numpy(), want)
    ids, ok = serving.rs.decode_payload_rows(want, serving.USER_BYTES)
    assert ok.all() and np.array_equal(ids, pixels[b])
    np.testing.assert_array_equal(want, serving.encode_rows(pixels[b]))
