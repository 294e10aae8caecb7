"""A stream cell admitted by files and entries alone: its configuration,
its workload, its name among the cells of ``decoded_samples_per_s``, a
roofline entry and one new span reader, in a copy of the benchmark.  The
harness takes it with no edit to a file it has, and finds every kernel's
launch counter by itself."""

from __future__ import annotations

import copy
import hashlib
import json

import pytest
import torch

from ofdm_tpu_torch.obs import profiler
from rxbench import registry, run, trace
from rxbench.metrics import program_spans
from conftest import (STREAM_CONFIG, add_cell_to, add_missing, copy_data,
                      shrink, with_streams)

CELL = "stream_hamming_qam64_f2048"
READER = "stream_hamming_device_ms_per_step"
READER_SOURCE = '''\
"""Device ms a call inside the program's ``stream.hamming`` spans."""

from rxbench.metrics import program_spans


def read(view):
    return program_spans.device_ms_per_step(view, "stream.hamming",
                                            call="stream.decode_regular")
'''
COUNTERS = ("sync_align", "planar_align", "eq_demod_pack", "derot_dft",
            "sync_keys", "pin_rowmajor", "sync_align_chunked")


def admit(root):
    """BENCHMARK.json and the data folders copied under ``root``, with the
    stream cell admitted as entries and one reader file, each where the
    benchmark lacks it; returns (the admitted benchmark, its data
    folder)."""
    data = copy_data(root / "rxbench")
    (data / "metrics" / f"{READER}.py").write_text(READER_SOURCE)
    b = copy.deepcopy(registry.benchmark())
    add_missing(b["configs"], [dict(
        STREAM_CONFIG, source="IEEE 802.11a-1999 cl.17, Hamming(7,4)",
        why="the stream path: K3, the Hamming decode")])
    add_missing(b["workloads"], [
        {"name": CELL, "config": STREAM_CONFIG["name"],
         "traffic": "stream_f2048", "chips": 1,
         "why": "2,048-frame streams, closed loop"}])
    add_cell_to(next(m for m in b["end_to_end"]
                     if m["name"] == "decoded_samples_per_s"), CELL)
    add_missing(b["per_layer"], [
        {"name": "planar_align_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "sync and align",
         "moves": "decoded_samples_per_s", "workloads": [CELL]},
        {"name": READER, "unit": "ms", "better": "lower",
         "source": "program_span",
         "layer": "front half and Hamming, torch ops",
         "moves": "decoded_samples_per_s", "workloads": [CELL]}])
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=2))
    return registry.benchmark(root / "BENCHMARK.json"), data


def committed_files() -> dict:
    """Every file of the harness and BENCHMARK.json, by its bytes and time
    of last change."""
    paths = [registry.REPO / "BENCHMARK.json"] + [
        p for p in registry.HERE.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts]
    return {str(p): (p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in paths}


def test_the_admitted_cell_validates(tmp_path):
    bench, data = admit(tmp_path)
    cells = registry.validate(bench, data)
    assert CELL in cells and "batch_qam64_b2048" in cells
    names = {m["name"] for m in registry.cell_metrics(bench, CELL, True)}
    assert {"planar_align_roofline", READER} <= names


def test_the_fixtures_leave_an_admitted_cell_as_it_is(tmp_path):
    bench, data = admit(tmp_path)
    once = with_streams(bench)
    registry.validate(once, data)
    assert with_streams(once) == once
    assert [w["name"] for w in once["workloads"]].count(CELL) == 1
    rate = next(m for m in once["end_to_end"]
                if m["name"] == "decoded_samples_per_s")
    assert rate["workloads"].count(CELL) == 1
    # and on the committed benchmark: applied twice, as once
    b = with_streams(registry.benchmark())
    assert with_streams(b) == b


@pytest.mark.parametrize("name", ("batch_qam64_b2048", CELL))
def test_the_admitted_benchmark_runs(tmp_path, name, capsys):
    before = committed_files()
    bench, data = admit(tmp_path)
    shrink(data)
    result = run.run(bench, name, 2**31 + 29, 0.3, False,
                     torch.device("cpu"), data=data)
    assert run.emit(result) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"decoded_samples_per_s", "setup_s"} <= set(line["metrics"])
    assert committed_files() == before


# the span readers with ``call=``, on stream calls filled in by hand

BASE = 9_000_000_000        # the program's host clock, ns
LAYERS = (("stream.sync", 2.3), ("stream.align", 0.6), ("rx.front", 3.2),
          ("rx.tail", 0.1), ("stream.hamming", 2.5), ("stream.fetch", 1.7))


def stream_calls(*intervals):
    """One ``decode_regular`` call per (start_s, end_s) on the trace's
    clock, with its six layer spans; the trace's clock marker sits 1 us
    after the call's start."""
    recs, markers = [], []
    for k, (s, e) in enumerate(intervals):
        clock = BASE + k * 1_000_000
        to_ns = lambda t: clock + round((t - s) * 1e9)   # noqa: E731
        top = len(recs)
        recs.append(profiler.SpanRecord("stream.decode_regular", None, k,
                                        to_ns(s), to_ns(e),
                                        clock_ns=clock + 1000,
                                        device_ms=11.0))
        for name, ms in LAYERS:
            recs.append(profiler.SpanRecord(name, top, k, to_ns(s) + 2000,
                                            to_ns(e) - 2000, device_ms=ms))
        markers.append((profiler.CLOCK_MARKER, s + 0.5e-6, s + 1.5e-6))
    return recs, markers


def view(markers, **kw) -> trace.View:
    base = dict(device=[("hamming", 0.0005, 0.004)],
                host=[("rxbench.window", 0.0, 0.01), *markers],
                start_s=0.0, end_s=0.01, steps=2, counters={}, figures={},
                shapes={}, kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return trace.View(**base)


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers these records in place of the program's."""
    def use(recs):
        monkeypatch.setattr(profiler, "records", lambda: recs)
    return use


def admitted_reader(tmp_path):
    _, data = admit(tmp_path)
    return registry.metric_reader(READER, data)


@pytest.mark.parametrize("name,ms", LAYERS)
def test_a_stream_layer_per_call(spans, name, ms):
    recs, markers = stream_calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    got = program_spans.device_ms_per_step(view(markers), name,
                                           call="stream.decode_regular")
    assert got == pytest.approx(ms)
    # counted against the batch entry point, stream calls are no steps
    assert program_spans.device_ms_per_step(view(markers), name) is None


def test_the_admitted_reader_reads_stream_hamming(spans, tmp_path):
    recs, markers = stream_calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    assert admitted_reader(tmp_path).read(view(markers)) == pytest.approx(2.5)


def test_a_stream_reader_finds_nothing_to_read(spans, monkeypatch, tmp_path):
    reader = admitted_reader(tmp_path)
    recs, markers = stream_calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    assert reader.read(view(markers, steps=3)) is None      # other steps
    assert reader.read(view(markers, steps=0)) is None
    for r in recs:
        r.device_ms = None                                  # a CPU run
    assert reader.read(view(markers)) is None
    monkeypatch.delattr(profiler, "records")                # no recorder
    assert reader.read(view(markers)) is None


def test_stream_calls_are_placed_by_their_markers(spans):
    recs, markers = stream_calls((0.0001, 0.0012), (0.0045, 0.006))
    call = "stream.decode_regular"
    got = program_spans.call_intervals(view(markers), recs, call=call)
    assert [t for iv in got for t in iv] == pytest.approx(
        [0.0001, 0.0012, 0.0045, 0.006])
    assert program_spans.call_intervals(view(markers), recs) == []
    assert program_spans.call_intervals(view(markers[:1]), recs,
                                        call=call) is None


# every launch counter of the program, found without a list

def test_launch_counters_finds_every_kernel():
    from ofdm_tpu_torch.kernels import align, demod, derot
    found = run.launch_counters()
    assert set(COUNTERS) <= set(found)
    assert found["sync_align"] == align.sync_align.launches
    assert found["planar_align"] == align.planar_align.launches
    assert found["eq_demod_pack"] == demod.eq_demod_pack.launches
    assert found["derot_dft"] == derot.derot_dft.launches
    assert all(type(n) is int for n in found.values())


def test_launch_counters_follow_the_launches(monkeypatch):
    from ofdm_tpu_torch.kernels import derot
    monkeypatch.setattr(derot.derot_dft, "launches",
                        derot.derot_dft.launches + 3)
    assert run.launch_counters()["derot_dft"] == derot.derot_dft.launches


def test_launch_counters_refuse_two_of_one_name(monkeypatch):
    from ofdm_tpu_torch.kernels import demod

    def sync_align():
        pass
    sync_align.__module__ = demod.__name__
    sync_align.launches = 0
    monkeypatch.setattr(demod, "sync_align", sync_align, raising=False)
    with pytest.raises(RuntimeError, match="two launch counters named"):
        run.launch_counters()
