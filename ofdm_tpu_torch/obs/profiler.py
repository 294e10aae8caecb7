"""Profiler hooks (port of ofdm_tpu/obs/profiler.py, redesigned for CUDA).

Wrap a section in ``trace(log_dir)`` to capture a ``torch.profiler`` trace
(CPU activity and, on a card, CUDA kernels) as a chrome trace file in
``log_dir`` (open it in chrome://tracing or Perfetto); ``timed(name)`` logs
a wall-clock span that ends only when the card has finished its queued
work; ``annotate(name)`` names a region that shows in a trace.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

log = logging.getLogger("ofdm_tpu_torch.profiler")

TRACE_NAME = "trace.json"


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
