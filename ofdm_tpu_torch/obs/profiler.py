"""Profiler hooks (port of ofdm_tpu/obs/profiler.py, redesigned for CUDA).

Wrap a section in ``trace(log_dir)`` to capture a ``torch.profiler`` trace
(CPU activity and, on a card, CUDA kernels) as a chrome trace file in
``log_dir`` (open it in chrome://tracing or Perfetto); ``timed(name)`` logs
a wall-clock span that ends only when the card has finished its queued
work; ``annotate(name)`` names a region that shows in a trace.

``span(name, x)`` marks a layer of the decode path (``phy/rx.py``,
``phy/streaming.py``).  It records only while a ``torch.profiler`` session
records; ``records()`` then gives each span's host interval and, for a
tensor ``x`` on a card, its device milliseconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger("ofdm_tpu_torch.profiler")

TRACE_NAME = "trace.json"
CLOCK_MARKER = "ofdm_tpu_torch.clock"


@contextlib.contextmanager
def trace(log_dir: str = "ofdm_tpu_torch_trace"):
    """Capture a ``torch.profiler`` trace of the enclosed block and write it
    to ``log_dir/trace.json`` (chrome trace format).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()     # the queued kernels belong to the block
    prof.export_chrome_trace(str(out / TRACE_NAME))


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock span logged at DEBUG.  Where CUDA is initialised the span
    ends after ``torch.cuda.synchronize()``: launches return before the card
    has run them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        log.debug("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces
    (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


# Layer spans.  A ``record_function`` range that encloses launches is drawn
# on the device timeline too, as a user annotation spanning its kernels, so
# a trace's device items would gain one item per span and count the span's
# kernels twice.  A span therefore keeps its host interval on the host
# clock and its device interval in a pair of CUDA events, both in memory.
# Only the clock marker goes into the trace: a ``record_function`` that
# encloses no launch, opened at each outermost span's entry around one read
# of the host clock, so that a reader can place the call's host interval on
# the trace's own clock.


@dataclasses.dataclass(eq=False)
class SpanRecord:
    """One span.  Host times are ``time.perf_counter_ns()``.  A span's self
    time is its interval less the part its children (the records whose
    ``parent`` is its index) cover."""
    name: str
    parent: int | None      # index in records() of the enclosing span
    call: int               # number of the outermost span, shared by its children
    host_start_ns: int
    host_end_ns: int | None = None
    clock_ns: int | None = None     # outermost: host clock read inside the marker
    device_ms: float | None = None  # from the events, once records() resolved them
    events: tuple | None = None     # (start, end) CUDA events until then


_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_records: list[SpanRecord] = []
_calls = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "x", "stream", "record")

    def __init__(self, name: str, x):
        self.name, self.x = name, x

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        clock_ns = None
        if stack:
            parent = stack[-1]
            call = _records[parent].call
        else:
            parent, call = None, next(_calls)
            with torch.profiler.record_function(CLOCK_MARKER):
                clock_ns = time.perf_counter_ns()
        rec = SpanRecord(self.name, parent, call, time.perf_counter_ns(),
                         clock_ns=clock_ns)
        if isinstance(self.x, torch.Tensor) and self.x.is_cuda:
            self.stream = torch.cuda.current_stream(self.x.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        with _lock:
            stack.append(len(_records))
            _records.append(rec)
        self.record = rec

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.host_end_ns = time.perf_counter_ns()
        _local.stack.pop()
        return False


def span(name: str, x=None):
    """A context manager that records the span ``name`` while a
    ``torch.profiler`` session records, and one shared null context
    otherwise (no clock read, no allocation, no CUDA call).  ``x`` is a
    tensor the layer works on: on a card, two CUDA events on its device's
    current stream time the work the span enqueues there.  Nothing in a
    span waits for the card."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, x)


def records() -> list[SpanRecord]:
    """The spans recorded since ``reset()``, in the order they were
    entered.  Each finished span's events are resolved to ``device_ms``
    here: this waits for the card once, for the last event recorded."""
    with _lock:
        recs = list(_records)
    pending = [r for r in recs
               if r.events is not None and r.host_end_ns is not None]
    if pending:
        max(pending, key=lambda r: r.host_end_ns).events[1].synchronize()
    for r in pending:
        start, end = r.events
        end.synchronize()       # done already where it shares the last stream
        r.device_ms = start.elapsed_time(end)
        r.events = None
    return recs


def reset() -> None:
    """Forget every span recorded so far (call it outside any span)."""
    with _lock:
        _records.clear()
