"""The runner end to end on the CPU at tiny sizes, and its refusals."""

from __future__ import annotations

import json

import pytest
import torch

from rxbench import registry, run

CELLS = ("batch_qam64_b2048", "stream_hamming_qam64_f2048",
         "live_stream_hamming_qam64_f2048")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", CELLS)
def test_runner_prints_one_result_line(tiny, bench, name, capsys):
    result = run.run(bench, name, 2**31 + 17, 0.3, False,
                     torch.device("cpu"), data=tiny)
    assert run.emit(result) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    wanted = {m["name"] for m in registry.cell_metrics(bench, name, False)}
    assert set(line["metrics"]) == wanted
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert out.err.strip().splitlines()[-1].startswith(
        "check byte_mismatch_ppm 0.0 limit")


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(tiny, bench, name):
    w = registry.cell(bench, name)
    drv = registry.driver(registry.traffic(w["traffic"], tiny)["driver"], tiny)
    cfg = registry.config(w["config"], tiny)
    tr = registry.traffic(w["traffic"], tiny)
    a = drv.Cell(cfg, tr, 5, torch.device("cpu")).inputs
    b = drv.Cell(cfg, tr, 5, torch.device("cpu")).inputs
    c = drv.Cell(cfg, tr, 6, torch.device("cpu")).inputs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [x.shape for x in a] == [x.shape for x in c]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_emit_refuses_a_process_holding_jax(monkeypatch, capsys):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "ofdm_tpu", types.ModuleType("ofdm_tpu"))
    assert run.banned_modules() == ["ofdm_tpu"]
    assert run.emit({"check": {}, "answers_compared": 0}) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "ofdm_tpu" in out.err


def test_the_port_is_not_the_jax_package(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "ofdm_tpu_torch_extra",
                        types.ModuleType("ofdm_tpu_torch_extra"))
    assert "ofdm_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert run.banned_modules() == []


def test_process_age_is_positive():
    assert 0 < run.process_age() < 3600


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_runner_on_the_card(card, tiny, bench, name):
    result = run.run(bench, name, 3, 1.0, True, card, data=tiny)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert result["device"]["platform"] == "gpu"


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and rxbench/, the
    command exits non-zero and prints no result."""
    import shutil
    import subprocess
    import sys
    shutil.copy(registry.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "rxbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
