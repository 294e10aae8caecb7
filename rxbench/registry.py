"""Finds and checks the benchmark's parts by the names ``BENCHMARK.json`` gives.

A cell names a configuration and a traffic mix; each is a JSON file of its
own (``configs/<name>.json``, ``workloads/<traffic>.json``).  The traffic
file names its driver, a module ``drivers/<driver>.py``; every per-layer
metric is a module ``metrics/<name>.py`` with a ``read(view)`` function;
every cell that is checked for ``correct`` has ``limits/<cell>.json``.  A
later change adds a cell, a configuration or a metric by adding files and
entries: no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}


class BenchmarkError(ValueError):
    """BENCHMARK.json or a file it names breaks a rule of the harness."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return load_json(path)


def config(name: str, data: Path = HERE) -> dict:
    return load_json(data / "configs" / f"{name}.json")


def traffic(name: str, data: Path = HERE) -> dict:
    return load_json(data / "workloads" / f"{name}.json")


def limits(cell: str, data: Path = HERE) -> dict:
    return load_json(data / "limits" / f"{cell}.json")


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.is_file():
        raise BenchmarkError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, data: Path = HERE):
    return _module(data / "drivers" / f"{name}.py", f"rxbench_driver_{name}")


def metric_reader(name: str, data: Path = HERE):
    return _module(data / "metrics" / f"{name}.py", f"rxbench_metric_{name}")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchmarkError(f"no workload named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a metric is read in a cell: every cell without a
    ``workloads`` key, else the cells it lists."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if reports(m, cell_name)]


def validate(bench: dict, data: Path = HERE) -> list[str]:
    """Every rule the harness relies on; raises BenchmarkError with all the
    faults found, else returns the cells' names."""
    faults = []

    def name_ok(what, v):
        if not isinstance(v, str) or not NAME.fullmatch(v):
            faults.append(f"{what} {v!r} is not a name")

    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        name_ok("config", c["name"])
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
        if not (data / "configs" / f"{c['name']}.json").is_file():
            faults.append(f"config {c['name']} has no file")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        faults.append("no setup_s")
    cells = [w["name"] for w in bench["workloads"]]
    if len(set(cells)) != len(cells):
        faults.append("two cells share a name")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(set(pairs)) != len(pairs):
        faults.append("a configuration and traffic pair appears twice")
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {key}", w[key])
        if w["config"] not in configs:
            faults.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            faults.append(f"{w['name']}: chips must be 1 or 4")
        path = data / "workloads" / f"{w['traffic']}.json"
        if not path.is_file():
            faults.append(f"{w['name']}: no traffic file {path.name}")
        elif not (data / "drivers" / f"{load_json(path)['driver']}.py").is_file():
            faults.append(f"{w['name']}: its traffic names no driver file")
        if not (data / "limits" / f"{w['name']}.json").is_file():
            faults.append(f"{w['name']}: no limits file")
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    if len(set(names)) != len(names):
        faults.append("two metrics share a name")
    for m in metrics:
        name_ok("metric", m["name"])
        if not UNIT.fullmatch(str(m.get("unit", ""))):
            faults.append(f"{m['name']}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            faults.append(f"{m['name']}: better must be lower or higher")
        for c in m.get("workloads", []):
            if c not in cells:
                faults.append(f"{m['name']}: unknown cell {c}")
    for m in bench["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            faults.append(f"{m['name']}: source {m['source']}")
    for m in bench["per_layer"]:
        if m["source"] not in SOURCES:
            faults.append(f"{m['name']}: source {m['source']}")
        moved = e2e.get(m.get("moves"))
        if moved is None:
            faults.append(f"{m['name']}: moves no end-to-end metric")
        else:
            for c in cells:
                if reports(m, c) and not reports(moved, c):
                    faults.append(f"{m['name']}: cell {c} does not report "
                                  f"{moved['name']}")
        if not (data / "metrics" / f"{m['name']}.py").is_file():
            faults.append(f"{m['name']}: no reader file")
    for c in cells:
        own = [m for m in bench["end_to_end"] if reports(m, c)]
        if len(own) < 2:
            faults.append(f"{c}: reports setup_s and no other end-to-end metric")
        if not any(reports(m, c) for m in bench["per_layer"]):
            faults.append(f"{c}: reports no per-layer metric")
    if faults:
        raise BenchmarkError("; ".join(faults))
    return cells
