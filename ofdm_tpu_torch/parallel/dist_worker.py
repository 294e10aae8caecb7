"""One rank of a localhost world (port of tools/dist_worker.py).

    python -m ofdm_tpu_torch.parallel.dist_worker --rank R --nprocs N \\
        --port P --spec cases.json --inputs cases.npz --out-dir DIR \\
        [--device cuda|cpu]

Start one such process per rank, all with the same port.  Each rank joins
the world over ``tcp://localhost:P`` (``initialize``: NCCL on CUDA, the
default, or gloo with ``--device cpu``), then runs the spec's cases in
order, every rank alike.  A case names a kind (``KINDS``), a mesh shape
[n_data, n_time] and keyword arguments; its arrays are ``<case>/<name>``
in the .npz.  A rank writes its outputs to ``DIR/out_R.npz``
(``<case>/<output>``: this rank's block, as the sharded functions return
it) and ``DIR/report_R.json``: per case its mesh coordinate (None, and no outputs, for a rank outside a mesh
smaller than the world), the collectives it made (``parallel.halo``'s
counters), the kernels it launched (each wrapper's ``launches``; 0 on the
CPU, where the wrappers run their plain versions) and its seconds; ``ok``
and the traceback of a failure.

Run as a script, it blocks jax and sets one thread before it imports the
rest.
"""

import sys

if __name__ == "__main__":
    sys.modules["jax"] = None   # the port never needs jax; make sure of it

import torch  # noqa: E402

if __name__ == "__main__":
    torch.set_num_threads(1)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ..config import FrameConfig  # noqa: E402
from ..kernels import counters  # noqa: E402
from ..ops.fft import set_full_fp32  # noqa: E402
from ..phy.modulation import Modulation  # noqa: E402
from . import halo  # noqa: E402
from .distributed import initialize  # noqa: E402
from .mesh import (DATA_AXIS, TIME_AXIS, axis_index, backend_for,  # noqa: E402
                   data_sharding, make_mesh, shard, time_sharding)
from .pipeline import (decode_burst_sharded, decode_frame_planar_sharded,  # noqa: E402
                       decode_frame_sharded, decode_regular_sharded,
                       make_pipeline_step, sharded_sync_offset)
from .timeshard import channel_timesharded_fn, decode_frame_timesharded  # noqa: E402


def _sync(mesh, a, kw):
    return {"offsets": sharded_sync_offset(a["x"], mesh, **kw)}


def _decode_frame(mesh, a, kw):
    return {"out": decode_frame_sharded(a["x"], mesh, **kw)}


def _decode_frame_planar(mesh, a, kw):
    """kw ``layout``: "contiguous" planes [B, 2, T], or "strided", the view
    ``view_as_real(x).transpose(1, 2)``."""
    x = torch.as_tensor(a["x"])
    layout = kw.pop("layout", "contiguous")
    planes = torch.view_as_real(x).transpose(1, 2) if layout == "strided" \
        else torch.stack([x.real, x.imag], dim=1)
    return {"out": decode_frame_planar_sharded(planes, mesh, **kw)}


def _decode_regular(mesh, a, kw):
    payloads, ok = decode_regular_sharded(a["stream"], mesh, **kw)
    return {"payloads": payloads, "ok": ok}


def _decode_burst(mesh, a, kw):
    found = decode_burst_sharded(a["stream"], mesh, **kw)
    return {"positions": np.asarray([f[0] for f in found], np.int64),
            "payloads": np.asarray([f[1] for f in found], np.uint8),
            "ok": np.asarray([f[2] for f in found], bool)}


def _timeshard(mesh, a, kw):
    return {"out": decode_frame_timesharded(a["x"], mesh, **kw)}


def _channel(mesh, a, kw):
    seed = kw.pop("seed", 0)
    local = shard(torch.as_tensor(a["x"]), time_sharding(mesh))
    return {"out": channel_timesharded_fn(mesh, **kw)(local, seed)}


def _pipeline(mesh, a, kw):
    """kw ``steps`` (timed one by one, each ending in its error count's
    fetch) and ``seed`` (of the CPU generator the steps draw from)."""
    steps, seed = kw.pop("steps", 1), kw.pop("seed", 0)
    data = shard(torch.as_tensor(a["data"]), data_sharding(mesh))
    step = make_pipeline_step(mesh, **kw)
    gen = torch.Generator().manual_seed(seed)
    times, errs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        decoded, total = step(data, gen)
        errs.append(int(total[0]))
        times.append(time.perf_counter() - t0)
    return {"decoded": decoded, "errs": np.asarray(errs),
            "step_s": np.asarray(times)}


KINDS = {"sync": _sync, "decode_frame": _decode_frame,
         "decode_frame_planar": _decode_frame_planar,
         "decode_regular": _decode_regular, "decode_burst": _decode_burst,
         "timeshard": _timeshard, "channel": _channel, "pipeline": _pipeline}


def _keywords(kw: dict) -> dict:
    """A case's JSON keywords as the functions take them: ``modulation``
    by its value, ``cfg`` as FrameConfig fields."""
    kw = dict(kw)
    if "modulation" in kw:
        kw["modulation"] = Modulation(kw["modulation"])
    if "cfg" in kw:
        kw["cfg"] = FrameConfig(**kw["cfg"])
    return kw


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_rank(rank: int, nprocs: int, port: int, spec: dict, inputs,
             device: str) -> tuple[dict, dict]:
    """Join the world and run every case; returns (report, outputs).  On
    CUDA it turns TF32 off first, as the apps do (``set_full_fp32``)."""
    report: dict = {"rank": rank, "ok": False, "cases": {}}
    outputs: dict = {}
    try:
        if device == "cuda":
            set_full_fp32()
        report["started"] = initialize(coordinator=f"localhost:{port}",
                                       num_processes=nprocs, process_id=rank,
                                       backend=backend_for(device))
        report["world"] = dist.get_world_size()
        meshes: dict = {}
        for case in spec["cases"]:
            name, shape = case["name"], tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device_type=device)
            mesh = meshes[shape]
            dist.barrier()
            if mesh.get_coordinate() is None:       # a rank outside the mesh
                report["cases"][name] = {"coord": None}
                continue
            prefix = f"{name}/"
            args = {k[len(prefix):]: inputs[k] for k in inputs.files
                    if k.startswith(prefix)}
            halo.reset_counts()
            kernels = counters()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            res = KINDS[case["kind"]](mesh, args, _keywords(case.get("kw", {})))
            seconds = time.perf_counter() - t0
            outputs.update({prefix + k: _numpy(v) for k, v in res.items()})
            report["cases"][name] = {
                "coord": [axis_index(mesh, DATA_AXIS), axis_index(mesh, TIME_AXIS)],
                "counts": halo.counts(),
                "launches": {n: k.launches for n, k in kernels.items()},
                "seconds": seconds}
        report["ok"] = True
    except Exception:
        report["error"] = traceback.format_exc()
    return report, outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    with np.load(args.inputs) as inputs:
        report, outputs = run_rank(args.rank, args.nprocs, args.port, spec,
                                   inputs, args.device)
    out = Path(args.out_dir)
    np.savez(out / f"out_{args.rank}.npz", **outputs)
    (out / f"report_{args.rank}.json").write_text(json.dumps(report))
    if dist.is_initialized() and report["ok"]:
        dist.destroy_process_group()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
