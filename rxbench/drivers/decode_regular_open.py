"""A live capture feed: streams offered to
``ofdm_tpu_torch.phy.streaming.decode_regular`` in an open loop at a fixed
rate, ``rate_per_s`` buffers a second, however long decoding takes.

Buffer k is due at t0 + k / rate.  The decoder takes the next buffer as
soon as it is free and the buffer is due; while it is idle it waits for
the due time (sleeping, then spinning for the last millisecond).  A
buffer's latency runs from its due time to its user bytes on the host; a
buffer due in the window but not done by its end counts at its age then.
``latency_p95_ms`` is the nearest-rank 95th percentile over every buffer
due in the window.  The host figures: the median service time (a call's
start to its bytes on the host) and the most the generator ran behind its
schedule (a call's start after its due time, counted where the decoder
was idle when the buffer came due), and how much longer the last quarter
of the buffers waited than the first (a backlog that grows).
"""

from __future__ import annotations

import math
import statistics
import time

from rxbench import cell, trace
from rxbench.drivers import decode_regular

SPIN_S = 0.001


def wait_until(t: float) -> None:
    ahead = t - time.perf_counter() - SPIN_S
    if ahead > 0:
        time.sleep(ahead)
    while time.perf_counter() < t:
        pass


def p95(values: list) -> float:
    """Nearest rank: the ceil(0.95 n)-th smallest."""
    s = sorted(values)
    return s[math.ceil(0.95 * len(s)) - 1]


class Cell(decode_regular.Cell):
    def window(self, seconds: float, traced: bool) -> cell.Window:
        n_in = len(self.inputs)
        rate = self.tr["rate_per_s"]
        plan = cell.sample_plan(self.seed, n_in, seconds * rate)
        answers, latency, service, lag = [], [], [], []
        k = 0
        with trace.span(trace.WINDOW_SPAN, traced):
            t0 = time.perf_counter()
            end = t0 + seconds
            while t0 + k / rate < end:
                due = t0 + k / rate
                if time.perf_counter() < due:
                    with trace.span("rxbench.idle", traced):
                        wait_until(due)
                    start = time.perf_counter()
                    lag.append(start - due)
                else:
                    start = time.perf_counter()
                if start >= end:
                    break
                with trace.span("rxbench.call", traced):
                    out = self.step(k)
                done = time.perf_counter()
                service.append(done - start)
                latency.append(min(done, end) - due)
                self.keep(plan, k, out, answers)
                k += 1
            t1 = max(time.perf_counter(), end)
        served = k
        # buffers that came due in the window and never started
        while t0 + k / rate < end:
            latency.append(end - (t0 + k / rate))
            k += 1
        q = max(1, len(latency) // 4)
        growth = statistics.fmean(latency[-q:]) - statistics.fmean(latency[:q])
        return cell.Window(
            seconds=t1 - t0, steps=served, attempted=k, failed=k - served,
            metrics={"latency_p95_ms": 1e3 * p95(latency)},
            figures={"service_ms_p50": 1e3 * statistics.median(service),
                     "generator_lag_ms_max": 1e3 * max(lag, default=0.0),
                     "backlog_growth_ms": 1e3 * growth},
            answers=self.collected(answers, ((served - 1) % n_in, out)))
