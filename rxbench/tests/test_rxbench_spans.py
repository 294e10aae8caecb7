"""The readers of the program's layer spans, on a made-up trace and span
records filled in by hand."""

from __future__ import annotations

import pytest

from ofdm_tpu_torch.obs import profiler
from rxbench import registry, trace

BASE = 7_000_000_000        # the program's host clock, ns
NAMES = ("rx_sync_device_ms_per_step", "rx_front_device_ms_per_step",
         "rx_tail_device_ms_per_step", "rx_idle_ms_per_step")


def calls(*intervals):
    """One ``decode_frame`` call per (start_s, end_s) on the trace's clock:
    its four spans, sync 0.6 ms, front 0.8 ms and tail 0.1 ms on the
    device; the call's clock marker read the host clock at BASE + call ms,
    and the trace's marker sits 1 us after the call's start."""
    recs, markers = [], []
    for k, (s, e) in enumerate(intervals):
        clock = BASE + k * 1_000_000
        to_ns = lambda t: clock + round((t - s) * 1e9)   # noqa: E731
        top = len(recs)
        recs.append(profiler.SpanRecord("rx.decode_frame", None, k, to_ns(s),
                                        to_ns(e), clock_ns=clock + 1000,
                                        device_ms=1.6))
        for name, ms in (("rx.sync", 0.6), ("rx.front", 0.8),
                         ("rx.tail", 0.1)):
            recs.append(profiler.SpanRecord(name, top, k, to_ns(s) + 2000,
                                            to_ns(e) - 2000, device_ms=ms))
        markers.append((profiler.CLOCK_MARKER, s + 0.5e-6, s + 1.5e-6))
    return recs, markers


def view(markers, **kw) -> trace.View:
    """Two steps in a 10 ms window, the device busy 0.5-4 and 5.5-9 ms:
    idle 0.5 ms, then 1.5 ms, then 1 ms."""
    base = dict(device=[("gemm", 0.0005, 0.004), ("gemm", 0.0055, 0.009)],
                host=[("rxbench.window", 0.0, 0.01), *markers],
                start_s=0.0, end_s=0.01, steps=2, counters={}, figures={},
                shapes={}, kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return trace.View(**base)


def read(name, v):
    return registry.metric_reader(name).read(v)


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers these records in place of the program's."""
    def use(recs):
        monkeypatch.setattr(profiler, "records", lambda: recs)
    return use


def test_device_ms_per_step_of_each_layer(spans):
    recs, markers = calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    v = view(markers)
    assert read("rx_sync_device_ms_per_step", v) == pytest.approx(0.6)
    assert read("rx_front_device_ms_per_step", v) == pytest.approx(0.8)
    assert read("rx_tail_device_ms_per_step", v) == pytest.approx(0.1)


def test_idle_counts_the_gaps_inside_a_call(spans):
    # gap 0-0.5 ms lies in call 0, 4-5.5 ms in call 1, 9-10 ms in none
    recs, markers = calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    assert read("rx_idle_ms_per_step", view(markers)) == pytest.approx(1.0)
    # call 1 starts after the 4-5.5 ms gap's midpoint: only call 0's counts
    recs, markers = calls((0.0001, 0.0012), (0.0048, 0.006))
    spans(recs)
    assert read("rx_idle_ms_per_step", view(markers)) == pytest.approx(0.25)


def test_each_call_is_placed_by_its_own_marker(spans):
    # the host clock's reading moves between calls; the markers follow it
    recs, markers = calls((0.0001, 0.0012), (0.0045, 0.006))
    for r in recs[4:]:
        r.host_start_ns += 10**9
        r.host_end_ns += 10**9
    recs[4].clock_ns += 10**9
    spans(recs)
    assert read("rx_idle_ms_per_step", view(markers)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(spans, monkeypatch, name):
    recs, markers = calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    assert read(name, view(markers, steps=3)) is None       # other steps
    for r in recs:
        r.device_ms = None                                  # a CPU run
    assert read(name, view(markers)) is None
    monkeypatch.delattr(profiler, "records")                # no recorder
    assert read(name, view(markers)) is None


def test_idle_needs_every_marker(spans):
    recs, markers = calls((0.0001, 0.0012), (0.0045, 0.006))
    spans(recs)
    assert read("rx_idle_ms_per_step", view(markers[:1])) is None


def test_the_four_entries_validate(bench):
    """The four entries are there and read in the batch cell; other cells
    may join the benchmark and these metrics."""
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["moves"] == "decoded_samples_per_s"
        assert "batch_qam64_b2048" in m["workloads"]
    assert "batch_qam64_b2048" in registry.validate(registry.benchmark())
