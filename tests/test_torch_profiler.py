"""obs/profiler.py of the port: ``trace`` writes a chrome trace that names
the enclosed work, ``timed`` and ``annotate`` run without a card, with the
JAX package's names and context-manager use; the layer spans of
``decode_frame`` and ``decode_regular``."""

import contextlib
import inspect
import json
import logging

import numpy as np
import pytest
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu.obs import profiler as jprofiler
from ofdm_tpu_torch.obs import profiler
from ofdm_tpu_torch.phy import streaming

torch.set_num_threads(1)


def _decode_step():
    tx = ott.encode(bytes(range(64)), guard_bands=True,
                    modulation=ott.Modulation.QPSK, device="cpu")
    return ott.decode_frame(tx, n_blocks=ott.n_data_blocks(
        64, ott.Modulation.QPSK, True), guard_bands=True,
        modulation=ott.Modulation.QPSK)


def test_same_interface_as_the_jax_package():
    for name in ("trace", "timed", "annotate"):
        mine, theirs = getattr(profiler, name), getattr(jprofiler, name)
        assert list(inspect.signature(mine).parameters) == \
            list(inspect.signature(theirs).parameters), name
        assert isinstance(mine("x"), contextlib.AbstractContextManager)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiler.trace(str(log_dir)) as where:
        assert where == str(log_dir)
        with profiler.annotate("decode_step"):
            out = _decode_step()
    assert out.dtype == torch.uint8
    path = log_dir / profiler.TRACE_NAME
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "decode_step" in names                  # the annotation
    assert any(n and "aten::" in n for n in names)   # and the work inside it


def test_trace_is_written_when_the_block_raises(tmp_path):
    try:
        with profiler.trace(str(tmp_path)):
            raise KeyError("boom")
    except KeyError:
        pass
    else:
        raise AssertionError("the block's exception must propagate")


def test_timed_logs_a_span(caplog):
    assert not torch.cuda.is_initialized()
    with caplog.at_level(logging.DEBUG, logger="ofdm_tpu_torch.profiler"):
        with profiler.timed("step"):
            _decode_step()
    assert not torch.cuda.is_initialized()          # no card was touched
    [rec] = [r for r in caplog.records if r.name == "ofdm_tpu_torch.profiler"]
    assert rec.getMessage().startswith("step: ") and rec.getMessage().endswith(" ms")


def test_annotate_outside_a_trace_is_harmless():
    with profiler.annotate("nothing recording"):
        assert _decode_step().shape[0] > 0


# Layer spans: recorded only under a torch.profiler session, kept off its
# device timeline, identical bytes either way.

DECODE_FRAME = ["rx.decode_frame", "rx.sync", "rx.front", "rx.tail"]
SPAN_NAMES = {"rx.decode_frame", "rx.sync", "rx.front", "rx.tail",
              "stream.decode_regular", "stream.sync", "stream.align",
              "stream.hamming", "stream.fetch"}


def _regular_step(resync):
    data = np.random.default_rng(3).integers(0, 256, (3, 32), dtype=np.uint8)
    kw = dict(guard_bands=True, modulation=ott.Modulation.QPSK)
    frames = ott.encode_hamming(data, device="cpu", **kw)
    out, ok = streaming.decode_regular(
        frames.reshape(-1), n_frames=3, spacing=frames.shape[1],
        payload_len=streaming.coded_len(32, "hamming"), fec="hamming",
        data_len=32, resync=resync, **kw)
    assert ok.all() and np.array_equal(out, data)
    return out


def _recorded(step):
    """(the step's output untraced, traced, the span records, the
    profiler's events) of one step run in each way."""
    profiler.reset()
    plain = step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = step()
    recs = profiler.records()
    profiler.reset()
    return plain, traced, recs, prof.events()


def _tree(recs):
    """[(name, name of parent)] in entry order, one call id, each child's
    host interval inside its parent's."""
    assert {r.call for r in recs} == {recs[0].call}
    out = []
    for r in recs:
        assert r.host_start_ns <= r.host_end_ns and r.device_ms is None
        if r.parent is None:
            out.append((r.name, None))
            continue
        p = recs[r.parent]
        assert p.host_start_ns <= r.host_start_ns <= r.host_end_ns <= p.host_end_ns
        out.append((r.name, p.name))
    return out


def test_spans_are_off_without_a_profiler_session():
    profiler.reset()
    _decode_step()
    _regular_step(False)
    assert profiler.records() == []
    assert not torch.cuda.is_initialized()
    assert profiler.span("rx.sync") is profiler.span("stream.fetch")


def test_decode_frame_spans_nest_under_one_call():
    plain, traced, recs, _ = _recorded(_decode_step)
    assert torch.equal(plain, traced)
    assert _tree(recs) == [("rx.decode_frame", None)] + [
        (n, "rx.decode_frame") for n in DECODE_FRAME[1:]]
    assert recs[0].clock_ns is not None
    assert all(r.clock_ns is None for r in recs[1:])


@pytest.mark.parametrize("resync,inner", [
    (False, [("rx.front", "stream.decode_regular"),
             ("rx.tail", "stream.decode_regular")]),
    (True, [("rx.decode_frame", "stream.decode_regular"),
            ("rx.sync", "rx.decode_frame"), ("rx.front", "rx.decode_frame"),
            ("rx.tail", "rx.decode_frame")])])
def test_decode_regular_spans_nest_under_one_call(resync, inner):
    plain, traced, recs, _ = _recorded(lambda: _regular_step(resync))
    assert np.array_equal(plain, traced)
    top = "stream.decode_regular"
    assert _tree(recs) == [(top, None), ("stream.sync", top),
                           ("stream.align", top), *inner,
                           ("stream.hamming", top), ("stream.fetch", top)]


def test_only_the_clock_markers_reach_the_trace():
    for step in (_decode_step, lambda: _regular_step(True)):
        _, _, recs, events = _recorded(step)
        ours = [e for e in events if e.name.startswith("ofdm_tpu_torch")
                or e.name in SPAN_NAMES]
        outer = [r for r in recs if r.parent is None]
        assert [e.name for e in ours] == [profiler.CLOCK_MARKER] * len(outer)
        assert all(e.cpu_children == [] for e in ours)
        for e in ours:      # no op starts inside a marker
            assert not any(e.time_range.start < o.time_range.start
                           < e.time_range.end for o in events if o is not e)
