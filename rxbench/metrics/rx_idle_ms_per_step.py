"""Device idle ms a step while the host was inside ``decode_frame``: the
idle gaps of the traced window, found as ``trace.breakdown`` finds them,
whose midpoint falls inside an ``rx.decode_frame`` span, each call placed
on the trace's clock by its own clock marker."""

import bisect

from rxbench import trace
from rxbench.metrics import program_spans


def read(view):
    recs = program_spans.window_records(view)
    if recs is None:
        return None
    calls = program_spans.call_intervals(view, recs)
    if calls is None:
        return None
    starts = [s for s, _ in calls]
    busy = trace.merged(view.device)
    edges = [view.start_s] + [x for iv in busy for x in iv] + [view.end_s]
    idle = 0.0
    for a, b in zip(edges[0::2], edges[1::2]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if b > a and i >= 0 and mid < calls[i][1]:
            idle += b - a
    return 1e3 * idle / view.steps
