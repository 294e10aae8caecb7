"""Start a world of ``ofdm_tpu_torch.parallel.dist_worker`` ranks on this host
and wait for it; read the outputs back as global arrays.

``World(spec, arrays, nprocs, out_dir, device)`` writes the spec and the
arrays (``{"<case>/<name>": array}``) under ``out_dir`` and starts the
ranks at once; ``wait(timeout)`` returns ([report per rank], [outputs per
rank]) and raises, after killing every rank, when one fails or the time
runs out, so a hung world fails instead of stalling its caller.  A world
whose store port was taken between ``free_port`` and rank 0's bind starts
once more on a new port.  The device defaults to CUDA, as the worker's
does; CPU worlds (``device="cpu"``, gloo) hide the host's cards from their
ranks.  ``rows``, ``replicated`` and ``time_blocks`` assemble a case's
outputs from the ranks' blocks.

tests/test_torch_parallel.py and tests/test_torch_timeshard.py run their
gloo worlds through it, and ``chip_smoke.py`` (which loads this file by
path) its CPU worlds and its one-rank NCCL world.  The tests below check
the assemblers and the start-up.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# rank 0's error when another process took the store's port first
PORT_TAKEN = "EADDRINUSE"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """``nprocs`` worker processes on this host, started at once."""

    def __init__(self, spec: dict, arrays: dict, nprocs: int, out_dir,
                 device: str = "cuda", port: int | None = None):
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        (self.out / "spec.json").write_text(json.dumps(spec))
        np.savez(self.out / "inputs.npz", **arrays)
        self.env = dict(os.environ, OMP_NUM_THREADS="1",
                        PYTHONPATH=os.pathsep.join(
                            [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        if device == "cpu":
            self.env["CUDA_VISIBLE_DEVICES"] = ""
        self.nprocs, self.device = nprocs, device
        self.port = free_port() if port is None else port
        self.restarts = 0
        self._start()

    def _start(self) -> None:
        for r in range(self.nprocs):
            (self.out / f"report_{r}.json").unlink(missing_ok=True)
        self.logs = [open(self.out / f"stderr_{r}.txt", "w+")
                     for r in range(self.nprocs)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "ofdm_tpu_torch.parallel.dist_worker",
             "--rank", str(r), "--nprocs", str(self.nprocs),
             "--port", str(self.port),
             "--spec", str(self.out / "spec.json"),
             "--inputs", str(self.out / "inputs.npz"),
             "--out-dir", str(self.out), "--device", self.device],
            cwd=str(ROOT), env=self.env, stdout=subprocess.DEVNULL,
            stderr=self.logs[r]) for r in range(self.nprocs)]

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _watch(self, deadline: float, timeout: float) -> str | None:
        """None once every rank exited 0, else why the world failed."""
        while True:
            rcs = [p.poll() for p in self.procs]
            if any(rc not in (None, 0) for rc in rcs):
                time.sleep(0.5)               # let the others write reports
                return "a rank failed"
            if all(rc == 0 for rc in rcs):
                return None
            if time.monotonic() > deadline:
                return f"the world did not finish in {timeout} s"
            time.sleep(0.05)

    def _errors(self) -> list[str]:
        """Each rank's traceback from its report, else its stderr's tail."""
        errs = []
        for r, f in enumerate(self.logs):
            rep = self.out / f"report_{r}.json"
            err = json.loads(rep.read_text()).get("error") \
                if rep.exists() else None
            if err is None:
                f.seek(0)
                err = f.read()[-3000:]
            errs.append(f"rank {r} rc={self.procs[r].returncode}: {err}")
        return errs

    def wait(self, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                why = self._watch(deadline, timeout)
            finally:
                self._kill()
            errs = self._errors() if why else []
            for f in self.logs:
                f.close()
            if why is None:
                break
            if PORT_TAKEN in errs[0] and not self.restarts:
                self.restarts, self.port = 1, free_port()
                self._start()
                continue
            raise RuntimeError("\n".join([why, *errs]))
        reports = [json.loads((self.out / f"report_{r}.json").read_text())
                   for r in range(self.nprocs)]
        outputs = []
        for r in range(self.nprocs):
            with np.load(self.out / f"out_{r}.npz") as z:
                outputs.append({k: z[k] for k in z.files})
        return reports, outputs


def _blocks(reports, outputs, case: str, key: str):
    """(coordinate, output) of every rank in the case's mesh."""
    for rep, out in zip(reports, outputs):
        coord = rep["cases"][case]["coord"]
        if coord is not None:
            yield tuple(coord), out[f"{case}/{key}"]


def rows(reports, outputs, case: str, key: str) -> np.ndarray:
    """The global rows of a data-sharded output: the data blocks in order,
    after checking that every rank of a time line returned the same."""
    by_d: dict = {}
    for (d, _), val in _blocks(reports, outputs, case, key):
        if d in by_d and not np.array_equal(by_d[d], val):
            raise AssertionError(f"{case}/{key}: the ranks of data index {d} "
                                 "disagree")
        by_d[d] = val
    return np.concatenate([by_d[d] for d in sorted(by_d)])


def replicated(reports, outputs, case: str, key: str) -> np.ndarray:
    """An output every rank returned alike."""
    vals = [v for _, v in _blocks(reports, outputs, case, key)]
    if not all(np.array_equal(vals[0], v) for v in vals[1:]):
        raise AssertionError(f"{case}/{key}: the ranks disagree")
    return vals[0]


def time_blocks(reports, outputs, case: str, key: str) -> np.ndarray:
    """The global [B, T] of a time-sharded output from its (data, time)
    blocks."""
    grid: dict = {}
    for (d, t), val in _blocks(reports, outputs, case, key):
        grid[d, t] = val
    n_d = 1 + max(d for d, _ in grid)
    n_t = 1 + max(t for _, t in grid)
    return np.concatenate([np.concatenate([grid[d, t] for t in range(n_t)],
                                          axis=-1) for d in range(n_d)])


# -- the helpers themselves ---------------------------------------------------

def _grid(n_data: int, n_time: int, x: np.ndarray, idle: int = 0):
    """Reports and outputs of a (n_data, n_time) mesh holding the blocks of
    ``x`` [B, T], in rank order, and ``idle`` ranks outside the mesh."""
    reports, outputs = [], []
    b, t = x.shape[0] // n_data, x.shape[1] // n_time
    for d in range(n_data):
        for k in range(n_time):
            reports.append({"cases": {"c": {"coord": [d, k]}}})
            outputs.append({"c/blk": x[d * b:(d + 1) * b, k * t:(k + 1) * t],
                            "c/rows": x[d * b:(d + 1) * b],
                            "c/same": x[:1]})
    reports += [{"cases": {"c": {"coord": None}}}] * idle
    outputs += [{}] * idle
    return reports, outputs


def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except AssertionError:
        return True
    return False


def test_assemblers_rebuild_the_global_array():
    x = np.arange(8 * 12).reshape(8, 12)
    for shape, idle in (((1, 1), 0), ((4, 1), 0), ((2, 2), 0), ((1, 4), 0),
                        ((2, 3), 2)):
        reports, outputs = _grid(*shape, x, idle)
        np.testing.assert_array_equal(time_blocks(reports, outputs, "c", "blk"),
                                      x)
        np.testing.assert_array_equal(rows(reports, outputs, "c", "rows"), x)
        np.testing.assert_array_equal(replicated(reports, outputs, "c", "same"),
                                      x[:1])


def test_assemblers_refuse_ranks_that_disagree():
    x = np.arange(4 * 6).reshape(4, 6)
    reports, outputs = _grid(2, 2, x)
    outputs[1] = dict(outputs[1], **{"c/rows": outputs[1]["c/rows"] + 1,
                                     "c/same": outputs[1]["c/same"] + 1})
    assert _raises(rows, reports, outputs, "c", "rows")
    assert _raises(replicated, reports, outputs, "c", "same")


def test_world_restarts_once_when_its_port_was_taken(tmp_path):
    """A port another process holds fails rank 0's bind; the world starts
    again on a new port and finishes."""
    with socket.socket() as taken:
        taken.bind(("localhost", 0))
        taken.listen()
        port = taken.getsockname()[1]
        world = World({"cases": []}, {}, 1, tmp_path, device="cpu", port=port)
        reports, outputs = world.wait(timeout=120)
    assert world.restarts == 1 and world.port != port
    assert reports[0]["ok"] and reports[0]["world"] == 1 and outputs == [{}]


def test_world_defaults_to_the_card(tmp_path):
    """The worker and the launcher default to CUDA: without a card the world
    fails and says why; with one, the rank runs on NCCL."""
    world = World({"cases": []}, {}, 1, tmp_path)
    if torch.cuda.is_available():
        reports, _ = world.wait(timeout=120)
        assert reports[0]["ok"] and reports[0]["world"] == 1
        return
    try:
        world.wait(timeout=120)
    except RuntimeError as e:
        assert "rank 0" in str(e) and world.restarts == 0
    else:
        raise AssertionError("a CUDA world started without a card")
