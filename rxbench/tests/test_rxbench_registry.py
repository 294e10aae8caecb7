"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric dropped in as files are found and checked by name,
with no edit to a file that is there."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from rxbench import cell, registry, run
from conftest import copy_data


def added(data, bench):
    """A second batch configuration (QAM16), its traffic and cell, and a
    per-layer metric that reads only it: files and entries only."""
    cfg = json.loads((data / "configs" / "rx_batch_qam64.json").read_text())
    cfg.update(modulation="qam16", payload_bytes=64)
    cfg["row_samples"] = 800 + 80 * 5
    (data / "configs" / "rx_batch_qam16.json").write_text(json.dumps(cfg))
    (data / "workloads" / "batch_b3.json").write_text(json.dumps(
        {"driver": "decode_frame", "rows": 3, "inputs": 2,
         "timing_error": [False, True], "snr_db": [30.0, 45.0],
         "in_flight": 2, "trace_seconds": 1, "warm_seconds": 0}))
    (data / "limits" / "batch_qam16_b3.json").write_text(json.dumps(
        {"byte_mismatch_ppm": {"limit": 0}}))
    (data / "metrics" / "steps_seen.batch16.py").write_text(
        "def read(view):\n    return float(view.steps) or None\n")
    b = copy.deepcopy(bench)
    b["configs"].append({"name": "rx_batch_qam16", "source": "a test",
                         "file": "rxbench/configs/rx_batch_qam16.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "batch_qam16_b3", "config": "rx_batch_qam16",
                           "traffic": "batch_b3", "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append("batch_qam16_b3")
    b["per_layer"].append({"name": "steps_seen.batch16", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "host entry points",
                           "moves": "decoded_samples_per_s",
                           "workloads": ["batch_qam16_b3"]})
    return b


@pytest.fixture
def data(tmp_path):
    return copy_data(tmp_path / "data")


def test_the_committed_benchmark_validates():
    cells = registry.validate(registry.benchmark())
    assert "batch_qam64_b2048" in cells


def test_new_files_are_found_without_an_edit(data):
    bench = added(data, registry.benchmark())
    assert "batch_qam16_b3" in registry.validate(bench, data)
    names = [m["name"] for m in registry.cell_metrics(bench, "batch_qam16_b3",
                                                      True)]
    assert "steps_seen.batch16" in names
    reader = registry.metric_reader("steps_seen.batch16", data)
    assert reader.read(type("V", (), {"steps": 4})()) == 4.0
    result = run.run(bench, "batch_qam16_b3", 3, 0.2, False,
                     torch.device("cpu"), data=data)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"decoded_samples_per_s", "setup_s"}


@pytest.mark.parametrize("breakage,fault", [
    (lambda b: b["per_layer"][0].update(name="a name"), "is not a name"),
    (lambda b: b["per_layer"][0].update(unit="per second"), "unit"),
    (lambda b: b["configs"][0].update(name="x/y"), "is not a name"),
    (lambda b: b["per_layer"][0].update(moves="setup_s_typo"),
     "moves no end-to-end metric"),
    (lambda b: b["per_layer"][0].update(moves="latency_p95_ms"),
     "does not report latency_p95_ms"),
    (lambda b: b["end_to_end"][0]["workloads"].remove("batch_qam64_b2048"),
     "does not report"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="twin")),
     "appears twice"),
    (lambda b: b["per_layer"].append(dict(b["per_layer"][0], name="no_file")),
     "no reader file"),
])
def test_validation_names_the_fault(bench, breakage, fault):
    bench = copy.deepcopy(bench)
    breakage(bench)
    with pytest.raises(registry.BenchmarkError, match=fault):
        registry.validate(bench)


def test_a_metric_without_workloads_must_be_reported_by_every_cell(data,
                                                                   bench):
    bench = copy.deepcopy(bench)
    bench["per_layer"].append({"name": "device_idle_share_all", "unit": "share",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "decoded_samples_per_s"})
    (data / "metrics" / "device_idle_share_all.py").write_text(
        "def read(view):\n    return None\n")
    with pytest.raises(registry.BenchmarkError,
                       match="live_stream_hamming_qam64_f2048 does not report"):
        registry.validate(bench, data)


def test_sample_plan_covers_every_input_and_follows_the_seed():
    a = cell.sample_plan(2**33 + 1, 4, 1000)
    assert a == cell.sample_plan(2**33 + 1, 4, 1000)
    assert a != cell.sample_plan(2**33 + 2, 4, 1000)
    assert sorted(k % 4 for k in a) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert max(a) < 800 and sorted(a.values()) == list(range(8))
    assert sorted(k % 2 for k in cell.sample_plan(1, 2, 1)) == [0, 1]
