"""The traced window: what ``torch.profiler`` saw, reduced to what the
per-layer readers need.

A ``View`` holds the device items of the window (kernels, copies, sets) as
(name, start, end) in seconds on the profiler's clock, the host's ops and
the harness's own spans on the same clock, the steps the window ran, the
program's launch counters over the window, the driver's host-clock
figures and the shapes of the cell.  ``busy_s`` is the union of the
device items' intervals, so overlapping items count once.  The harness's
own spans, which the profiler also draws on the device's timeline, are
not device items.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

SPAN_PREFIX = "rxbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10
NAMED_GAPS = 2000         # the longest idle gaps are named; the rest summed


@dataclasses.dataclass
class View:
    device: list            # (name, start_s, end_s)
    host: list              # (name, start_s, end_s), ops and spans
    start_s: float
    end_s: float
    steps: int
    counters: dict
    figures: dict
    shapes: dict
    kind: str

    @property
    def window_s(self) -> float:
        return self.end_s - self.start_s

    def seconds(self, keep) -> float:
        return sum(e - s for n, s, e in self.device if keep(n))

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device))


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def merged(items) -> list:
    """The union of the items' intervals, as sorted disjoint (start, end)."""
    out = []
    for _, s, e in sorted(items, key=lambda d: d[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span(name: str, on: bool):
    """A named host span in the trace, or nothing when untraced."""
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof) -> tuple[list, list, float, float]:
    """(device items, host items, window start, window end) of a finished
    profiler session whose window ran inside a WINDOW_SPAN span."""
    from torch.autograd import DeviceType
    dev, host = [], []
    window = None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            # the harness's spans are drawn on the device's timeline too
            if not e.name.startswith(SPAN_PREFIX):
                dev.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name == WINDOW_SPAN:
                window = (s, t)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    inside = [(n, max(s, w0), min(t, w1)) for n, s, t in dev
              if t > w0 and s < w1]
    if not inside:
        raise RuntimeError("torch.profiler saw no device activity in the window")
    return inside, host, window[0], window[1]


def _host_doing(host: list, starts, ends, t: float) -> str:
    """What the host was doing at time t: the outermost harness span and
    the innermost op around t."""
    around = [host[i] for i in np.nonzero((starts <= t) & (ends > t))[0]
              if host[i][0] != WINDOW_SPAN]
    if not around:
        return "nothing traced"
    ours = [h for h in around if h[0].startswith(SPAN_PREFIX)]
    inner = min(around, key=lambda h: h[2] - h[1])[0]
    outer = max(ours, key=lambda h: h[2] - h[1])[0] if ours else ""
    return f"{outer}/{inner}"[:120] if outer and outer != inner else inner[:120]


def breakdown(view: View) -> dict:
    """The device items that took most time, and the idle time by what the
    host was doing, TOP of each, in seconds."""
    by_name: dict = {}
    for n, s, e in view.device:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = merged(view.device)
    edges = [view.start_s] + [x for iv in busy for x in iv] + [view.end_s]
    spans = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                    if b > a), key=lambda g: g[0] - g[1])
    starts = np.array([h[1] for h in view.host])
    ends = np.array([h[2] for h in view.host])
    gaps: dict = {}
    for i, (a, b) in enumerate(spans):
        what = _host_doing(view.host, starts, ends, (a + b) / 2) \
            if i < NAMED_GAPS else "shorter gaps"
        gaps[what] = gaps.get(what, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
