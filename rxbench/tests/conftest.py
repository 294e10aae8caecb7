"""Shared fixtures of the harness's CPU tests: a copy of the harness's data
folders, cut to sizes a CPU decodes in a moment."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rxbench import registry  # noqa: E402
from rxbench.wire import frame  # noqa: E402

DATA = ("configs", "workloads", "drivers", "metrics", "limits")


def copy_data(dest: Path) -> Path:
    for d in DATA:
        shutil.copytree(registry.HERE / d, dest / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def shrink(data: Path, rows: int = 4, payload: int = 64, frames: int = 3,
           user: int = 40) -> Path:
    """Cut every configuration and traffic file in ``data`` to small sizes,
    with no timed warm-up; the SNR range is kept."""
    for p in (data / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        if "payload_bytes" in cfg:
            # sync + the data blocks + one spare symbol, as the real rows
            blocks = frame.n_data_blocks(payload, cfg["modulation"],
                                         cfg["guard_bands"])
            edit(p, payload_bytes=payload,
                 row_samples=frame.SYNC_LEN + (blocks + 1) * frame.SYM_LEN)
        if "user_bytes" in cfg:
            edit(p, user_bytes=user)
    for p in (data / "workloads").glob("*.json"):
        tr = json.loads(p.read_text())
        edit(p, warm_seconds=0.0,
             **({"rows": rows} if "rows" in tr else {"frames": frames}))
    return data


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One CPU thread for torch: the tiny cells' calls then take steady
    milliseconds on a host shared with other work, where a pool of threads
    makes some calls tens of times slower and backs up the live cell's
    open loop."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path) -> Path:
    return shrink(copy_data(tmp_path / "data"))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


STREAM_CELLS = {
    "stream_hamming_qam64_f2048": "stream_f2048",
    "live_stream_hamming_qam64_f2048": "live_f2048",
}


STREAM_CONFIG = {"name": "rx_stream_hamming_qam64", "source": "PERF.md",
                 "file": "rxbench/configs/rx_stream_hamming_qam64.json",
                 "reduced": [], "why": "stream decode"}
STREAM_END_TO_END = [
    {"name": "latency_p95_ms", "unit": "ms", "better": "lower",
     "bound": 0.25, "source": "host_clock",
     "workloads": ["live_stream_hamming_qam64_f2048"]}]
STREAM_PER_LAYER = [
    {"name": "planar_align_roofline", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "sync and align",
     "moves": "decoded_samples_per_s",
     "workloads": ["stream_hamming_qam64_f2048"]},
    {"name": "service_ms_p50.live", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "live loop",
     "moves": "latency_p95_ms",
     "workloads": ["live_stream_hamming_qam64_f2048"]},
    {"name": "generator_lag_ms.live", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "live loop",
     "moves": "latency_p95_ms",
     "workloads": ["live_stream_hamming_qam64_f2048"]}]


def add_missing(group: list, entries: list) -> None:
    """Append to a list of named entries each entry whose name it lacks."""
    have = {e["name"] for e in group}
    group += [copy.deepcopy(e) for e in entries if e["name"] not in have]


def add_cell_to(metric: dict, cell: str) -> None:
    """List a cell among a metric's cells, where the metric lists its cells
    and not yet this one."""
    if "workloads" in metric and cell not in metric["workloads"]:
        metric["workloads"].append(cell)


def with_streams(bench: dict) -> dict:
    """BENCHMARK.json with the stream cells whose files are under rxbench/:
    a closed-loop stream cell and the live feed, with the metrics they
    report.  Only what the benchmark lacks is added, each entry matched by
    name, so the cells run here whether they are committed or not, and a
    second application changes nothing."""
    b = copy.deepcopy(bench)
    add_missing(b["configs"], [STREAM_CONFIG])
    add_missing(b["workloads"], [
        {"name": cell, "config": STREAM_CONFIG["name"], "traffic": tr,
         "chips": 1, "why": "a test"} for cell, tr in STREAM_CELLS.items()])
    add_cell_to(next(m for m in b["end_to_end"]
                     if m["name"] == "decoded_samples_per_s"),
                "stream_hamming_qam64_f2048")
    add_missing(b["end_to_end"], STREAM_END_TO_END)
    add_missing(b["per_layer"], STREAM_PER_LAYER)
    return b


@pytest.fixture
def bench() -> dict:
    """BENCHMARK.json and the stream cells, checked."""
    b = with_streams(registry.benchmark())
    registry.validate(b)
    return b
