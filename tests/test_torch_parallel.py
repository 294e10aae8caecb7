"""The port's parallel/ on a 4-rank gloo world against the JAX package.

The cases of tests/test_parallel.py without its jit-retrace ones: sharded
sync, the data-sharded batched decoders (fused, chunked, planar, strided),
the data-sharded stream decoders and the full pipeline step, on the meshes
(4, 1), (2, 2) and (1, 4) of one world of four CPU processes
(``tests/test_torch_world.py``; the whole world under one 300 s limit).  The
inputs are made here from seeded numpy payloads and noise, framed by the JAX
package (complex64), and the references are the JAX package's single-device
functions on the same samples, computed while the world runs.  Each case is
its own test reading the world's outputs.

The collective audit replaces tests/test_parallel.py's inventory of the
compiled HLO: it reads ``parallel.halo``'s counters, which every collective
of the port goes through.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu import constants as jconstants
from ofdm_tpu.fec import hamming as jhamming
from ofdm_tpu.phy import streaming as js
from tests.test_torch_world import World, replicated, rows

QPSK = ot.Modulation.QPSK
NB100 = ot.n_data_blocks(100, QPSK, True)
DELAYS = [13, 500, 1999, 3500]
BOUNDARY = 970                      # crosses the 1000-sample shard boundary
REG_FRAMES, REG_BYTES = 6, 96
BURST_GAPS = [0, 217, 3000, 941, 77]
PIPE = {"pipe_41": (4, 1), "pipe_22": (2, 2), "pipe_14": (1, 4)}


def _c64(x) -> np.ndarray:
    return np.asarray(x).astype(np.complex64)


def _inputs():
    """(cases, arrays, what the references need)."""
    rng = np.random.default_rng(0)
    lock = np.asarray(jconstants.locking_signal(80))
    streams = 0.01 * (rng.standard_normal((4, 4000))
                      + 1j * rng.standard_normal((4, 4000)))
    for i, d in enumerate(DELAYS):
        streams[i, d:d + 80] += lock
    one = 0.01 * (rng.standard_normal((1, 4000))
                  + 1j * rng.standard_normal((1, 4000)))
    one[0, BOUNDARY:BOUNDARY + 80] += lock

    data = rng.integers(0, 256, (8, 100), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=QPSK,
                   dtype=jnp.complex64)
    rx = _c64(ot.channel(tx, snr=30.0, key=jax.random.key(1)))

    user = rng.integers(0, 256, (REG_FRAMES, REG_BYTES), dtype=np.uint8)
    coded = np.asarray(jhamming.encode(jnp.asarray(user)))
    frames = _c64(ot.encode(coded, guard_bands=True, modulation=QPSK,
                            dtype=jnp.complex64))
    spacing = frames.shape[-1] + 160
    reg = np.zeros(37 + REG_FRAMES * spacing, np.complex64)
    for i in range(REG_FRAMES):
        reg[37 + i * spacing:37 + i * spacing + frames.shape[-1]] = frames[i]
    reg_kw = dict(n_frames=REG_FRAMES, spacing=spacing,
                  payload_len=coded.shape[-1], guard_bands=True,
                  modulation="qpsk", data_len=REG_BYTES)

    bdata = rng.integers(0, 256, (5, 64), dtype=np.uint8)
    btx = _c64(ot.encode(bdata, guard_bands=True, modulation=QPSK,
                         dtype=jnp.complex64))
    flen = btx.shape[-1]
    n = 6 * flen + sum(BURST_GAPS)
    burst = 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    pos, positions = 0, []
    for f, gap in zip(btx, BURST_GAPS):
        pos += gap
        burst[pos:pos + flen] += f
        positions.append(pos)
        pos += flen

    pipe_data = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    qam_data = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    frame_kw = dict(n_blocks=NB100, guard_bands=True, modulation="qpsk")
    cases = [
        dict(name="sync_22", kind="sync", mesh=[2, 2]),
        dict(name="sync_41", kind="sync", mesh=[4, 1]),
        dict(name="sync_14_boundary", kind="sync", mesh=[1, 4]),
        dict(name="frame_41", kind="decode_frame", mesh=[4, 1], kw=frame_kw),
        dict(name="frame_22_chunked", kind="decode_frame", mesh=[2, 2],
             kw=dict(frame_kw, align_impl="chunked")),
        dict(name="planar_41_fused", kind="decode_frame_planar", mesh=[4, 1],
             kw=frame_kw),
        dict(name="planar_22_chunked", kind="decode_frame_planar",
             mesh=[2, 2], kw=dict(frame_kw, align_impl="chunked")),
        dict(name="planar_14_strided", kind="decode_frame_planar",
             mesh=[1, 4], kw=dict(frame_kw, layout="strided")),
        dict(name="regular_41_hamming", kind="decode_regular", mesh=[4, 1],
             kw=dict(reg_kw, fec="hamming")),
        dict(name="regular_22_raw", kind="decode_regular", mesh=[2, 2],
             kw=dict(reg_kw, data_len=None)),
        dict(name="burst_41", kind="decode_burst", mesh=[4, 1],
             kw=dict(payload_len=64, guard_bands=True, modulation="qpsk")),
        dict(name="burst_22_max3", kind="decode_burst", mesh=[2, 2],
             kw=dict(payload_len=64, guard_bands=True, modulation="qpsk",
                     max_frames=3)),
    ]
    cases += [dict(name=name, kind="pipeline", mesh=list(shape),
                   kw=dict(payload_len=64, guard_bands=True, modulation="qpsk",
                           snr=30.0, timing_error=True, seed=3))
              for name, shape in PIPE.items()]
    # a mesh smaller than the world: ranks 2 and 3 sit the case out, and
    # the bit-error sum runs over the mesh's own group
    cases.append(dict(name="pipe_12_of_4", kind="pipeline", mesh=[1, 2],
                      kw=dict(payload_len=64, guard_bands=True,
                              modulation="qpsk", snr=30.0, timing_error=True,
                              seed=6)))
    cases.append(dict(name="pipe_qam64_22", kind="pipeline", mesh=[2, 2],
                      kw=dict(payload_len=32, guard_bands=True,
                              modulation="qam64", snr=45.0,
                              timing_error=False, seed=4)))
    arrays = {"sync_22/x": _c64(streams), "sync_41/x": _c64(streams),
              "sync_14_boundary/x": _c64(one), "regular_41_hamming/stream": reg,
              "regular_22_raw/stream": reg, "burst_41/stream": _c64(burst),
              "burst_22_max3/stream": _c64(burst),
              "pipe_qam64_22/data": qam_data, "pipe_12_of_4/data": pipe_data}
    for c in cases:
        if c["kind"] in ("decode_frame", "decode_frame_planar"):
            arrays[c["name"] + "/x"] = rx
        elif c["name"] in PIPE:
            arrays[c["name"] + "/data"] = pipe_data
    need = dict(streams=_c64(streams), one=_c64(one), rx=rx, data=data,
                reg=reg, reg_kw=reg_kw, user=user, burst=_c64(burst),
                bdata=bdata, positions=positions, pipe_data=pipe_data,
                qam_data=qam_data)
    return cases, arrays, need


def _references(need) -> dict:
    """The JAX package's single-device results on the same samples."""
    kw = dict(need["reg_kw"], modulation=QPSK)
    burst_kw = dict(payload_len=64, guard_bands=True, modulation=QPSK)
    stream = jnp.asarray(need["reg"])
    return {
        "sync": np.asarray(ot.sync_offset(jnp.asarray(need["streams"]))),
        "sync_one": np.asarray(ot.sync_offset(jnp.asarray(need["one"]))),
        "frame": np.asarray(ot.decode_frame(
            jnp.asarray(need["rx"]), n_blocks=NB100, guard_bands=True,
            modulation=QPSK)),
        "regular_hamming": js.decode_regular(stream, **dict(kw, fec="hamming")),
        "regular_raw": js.decode_regular(stream, **dict(kw, data_len=None)),
        "burst": js.decode_burst(jnp.asarray(need["burst"]), **burst_kw),
        "burst_max3": js.decode_burst(jnp.asarray(need["burst"]),
                                      max_frames=3, **burst_kw),
    }


class Run:
    def __init__(self, reports, outputs, refs, need):
        self.reports, self.outputs = reports, outputs
        self.refs, self.need = refs, need

    def rows(self, case, key):
        return rows(self.reports, self.outputs, case, key)

    def every(self, case, key):
        return replicated(self.reports, self.outputs, case, key)

    def counts(self, case):
        return [r["cases"][case].get("counts") for r in self.reports]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases, arrays, need = _inputs()
    world = World({"cases": cases}, arrays, 4, tmp_path_factory.mktemp("w4"),
                  device="cpu")
    refs = _references(need)          # while the world runs
    reports, outputs = world.wait(timeout=300)
    return Run(reports, outputs, refs, need)


def test_world_started(run):
    assert all(r["ok"] and r["started"] and r["world"] == 4 for r in run.reports)


@pytest.mark.parametrize("case", ["sync_22", "sync_41"])
def test_sharded_sync_matches_single_device(run, case):
    offs = run.rows(case, "offsets")
    np.testing.assert_array_equal(offs, run.refs["sync"])
    np.testing.assert_array_equal(offs, np.asarray(DELAYS) - 1)


def test_sharded_sync_peak_spanning_shard_boundary(run):
    offs = run.rows("sync_14_boundary", "offsets")
    np.testing.assert_array_equal(offs, run.refs["sync_one"])
    assert offs.tolist() == [BOUNDARY - 1]


@pytest.mark.parametrize("case", ["frame_41", "frame_22_chunked",
                                  "planar_41_fused", "planar_22_chunked",
                                  "planar_14_strided"])
def test_decode_frame_sharded_matches_decode_frame(run, case):
    out = run.rows(case, "out")
    np.testing.assert_array_equal(out, run.refs["frame"])
    np.testing.assert_array_equal(out[:, 16:116], run.need["data"])


def test_decode_regular_sharded_hamming(run):
    p, ok = run.every("regular_41_hamming", "payloads"), \
        run.every("regular_41_hamming", "ok")
    p1, ok1 = run.refs["regular_hamming"]
    np.testing.assert_array_equal(p, p1)
    np.testing.assert_array_equal(ok, ok1)
    np.testing.assert_array_equal(p, run.need["user"])
    assert ok.all()


def test_decode_regular_sharded_without_fec(run):
    p, ok = run.every("regular_22_raw", "payloads"), \
        run.every("regular_22_raw", "ok")
    p1, ok1 = run.refs["regular_raw"]
    np.testing.assert_array_equal(p, p1)
    np.testing.assert_array_equal(ok, ok1)


@pytest.mark.parametrize("case,ref", [("burst_41", "burst"),
                                      ("burst_22_max3", "burst_max3")])
def test_decode_burst_sharded_matches_single_device(run, case, ref):
    single = run.refs[ref]
    pos = run.every(case, "positions")
    pay = run.every(case, "payloads")
    assert run.every(case, "ok").all()
    assert pos.tolist() == [p for p, _, _ in single]
    # the reference's sync convention: detected = embedded position - 1
    want = [max(p - 1, 0) for p in run.need["positions"]][:len(single)]
    assert pos.tolist() == want
    for got, (_, a, _), d in zip(pay, single, run.need["bdata"]):
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(got, d)


@pytest.mark.parametrize("case", list(PIPE))
def test_pipeline_step_zero_errors(run, case):
    assert run.every(case, "errs").tolist() == [0]
    decoded = run.rows(case, "decoded")
    assert decoded.shape[0] == 8
    np.testing.assert_array_equal(decoded[:, 16:80], run.need["pipe_data"])


def test_pipeline_step_on_a_mesh_smaller_than_the_world(run):
    coords = [r["cases"]["pipe_12_of_4"]["coord"] for r in run.reports]
    assert coords == [[0, 0], [0, 1], None, None]
    assert run.every("pipe_12_of_4", "errs").tolist() == [0]
    np.testing.assert_array_equal(run.rows("pipe_12_of_4", "decoded")[:, 16:80],
                                  run.need["pipe_data"])
    for inv in run.counts("pipe_12_of_4")[:2]:
        assert inv["all_gather"]["calls"] == 0 and inv["permute"]["calls"] == 2


def test_pipeline_step_qam64(run):
    assert run.every("pipe_qam64_22", "errs").tolist() == [0]
    np.testing.assert_array_equal(run.rows("pipe_qam64_22", "decoded")[:, 16:48],
                                  run.need["qam_data"])


@pytest.mark.parametrize("case", list(PIPE) + ["pipe_qam64_22"])
def test_no_time_axis_allgather(run, case):
    """Each rank's collectives in one pipeline step: ring halos (the
    channel's left, the decode's right; none on a time line of one rank),
    all_reduces (the keys' max, the sync chunks, the bytes, the channel's
    mean and variance, the bit errors) and NO all_gather: the sample axis
    is never gathered.  The bytes stay within the structural bound of
    tests/test_parallel.py::test_no_time_axis_allgather."""
    n_data, n_time = dict(PIPE, pipe_qam64_22=(2, 2))[case]
    b_loc = (8 if case in PIPE else 4) // n_data
    for inv in run.counts(case):
        assert inv["all_gather"]["calls"] == 0, inv
        assert inv["permute"]["calls"] == (2 if n_time > 1 else 0), inv
        assert inv["all_reduce"]["calls"] == 6, inv
        sync_len, sym, n_bytes = 800, 80, 7 * 12 + 16
        structural = b_loc * (2 * (sym - 1) * 16 + 2 * 2 * sync_len * 8
                              + 2 * n_bytes * 8 + 64)
        total = sum(c["bytes"] for c in inv.values())
        assert total <= 2 * structural, (total, structural)


@pytest.mark.parametrize("case,gathers", [
    ("frame_41", 0), ("frame_22_chunked", 0), ("planar_41_fused", 0),
    ("planar_22_chunked", 0), ("planar_14_strided", 0),
    ("regular_41_hamming", 1), ("regular_22_raw", 1), ("burst_41", 2),
    ("burst_22_max3", 2)])
def test_data_sharded_steps_make_no_collective_before_their_gather(
        run, case, gathers):
    """The data-parallel steps communicate nothing but their outputs: the
    batched decoders nothing at all, the stream decoders one all_gather of
    the decoded bytes (and the burst scan one of its detection rows)."""
    for inv in run.counts(case):
        assert inv["all_gather"]["calls"] == gathers, inv
        assert inv["permute"]["calls"] == inv["all_reduce"]["calls"] == 0, inv


ONE_PROCESS = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import os
for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
    os.environ.pop(k, None)
import torch
import torch.distributed as dist
from ofdm_tpu_torch.parallel import distributed, halo, mesh as m

def raises(err, fn, *a, **kw):
    try:
        fn(*a, **kw)
    except err:
        return
    raise SystemExit(f"{fn.__name__}{a}{kw} did not raise {err.__name__}")

assert distributed.initialize() is False and not dist.is_initialized()
if not torch.cuda.is_available():
    raises(RuntimeError, m.make_mesh, device_type="cuda")
    assert not dist.is_initialized()
mesh = m.make_mesh(device_type="cpu")        # a world of one on a local store
assert dist.get_world_size() == 1 and mesh.mesh_dim_names == ("data", "time")
assert m.axis_size(mesh, "data") == m.axis_size(mesh, "time") == 1
raises(ValueError, m.make_mesh, 2, 1, device_type="cpu")
raises(ValueError, m.make_mesh, 1, 2, device_type="cpu")
assert m.axis_size(distributed.global_mesh(device_type="cpu"), "data") == 1
x = torch.arange(24.0).reshape(4, 6)
assert torch.equal(m.shard(x, m.data_sharding(mesh)), x)
assert torch.equal(m.shard(x, m.time_sharding(mesh)), x)
cpu = torch.device("cpu")
assert torch.equal(m.shard(x, m.Sharding((1, 2), (2, 3), cpu)), x[2:4, 4:6])
raises(ValueError, m.shard, x, m.Sharding((0, 3), None, cpu))
# a line of one: the ring hands a shard its own head or tail, as ppermute
y = torch.arange(10.0).to(torch.complex64)[None]
assert torch.equal(halo.right_halo(y, 3, mesh), torch.cat([y, y[:, :3]], -1))
assert torch.equal(halo.left_halo(y, 3, mesh), torch.cat([y[:, -3:], y], -1))
assert halo.global_argmax(torch.tensor([[0.0, 2.0, 5.0, 5.0, 1.0]]),
                          mesh).tolist() == [2]
assert torch.equal(halo.all_reduce(y, mesh), y)
assert torch.equal(halo.all_gather(y, mesh, "data"), y)
dist.destroy_process_group()
print("ok")
"""


def test_mesh_helpers_in_one_process():
    """Without torchrun's variables ``initialize`` starts nothing; a CUDA
    mesh raises without a card; ``make_mesh`` starts a world of one by
    itself and refuses a mesh larger than the world; the shardings index
    this rank's block; the collectives work on lines of one rank."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", ONE_PROCESS, str(root)],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
