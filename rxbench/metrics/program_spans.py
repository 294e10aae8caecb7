"""The program's own layer spans (``ofdm_tpu_torch.obs.profiler``) in the
traced window: device ms a step of the spans of one name, and the host
intervals of the entry point's calls placed on the trace's clock.

A step is one call of an entry point, named by its outermost span:
``rx.decode_frame`` unless a reader names another with ``call=`` (for a
stream cell, ``stream.decode_regular``).  The program records its spans
only while ``torch.profiler`` records, so in a run they cover the traced
window alone.  Each function returns None where the spans cannot be read:
a program without the recorder, a count of ``call`` spans other than the
window's steps, spans without device times (a run on the CPU), or a clock
marker missing from the trace.
"""

CALL = "rx.decode_frame"
MARKER = "ofdm_tpu_torch.clock"


def window_records(view, call: str = CALL):
    """The program's span records, if they are the traced window's calls."""
    try:
        from ofdm_tpu_torch.obs import profiler
    except ImportError:
        return None
    records = getattr(profiler, "records", None)
    if records is None:
        return None
    recs = records()
    calls = [r for r in recs if r.name == call]
    if not view.steps or len(calls) != view.steps \
            or any(r.device_ms is None for r in calls):
        return None
    return recs


def device_ms_per_step(view, name: str, call: str = CALL):
    recs = window_records(view, call)
    if recs is None:
        return None
    ms = [r.device_ms for r in recs if r.name == name]
    if not ms or None in ms:
        return None
    return sum(ms) / view.steps


def call_intervals(view, recs, call: str = CALL):
    """Sorted (start_s, end_s) of every ``call`` span on the trace's clock.
    The k-th outermost span read the host clock inside the trace's k-th
    clock marker; the marker's midpoint less that reading places the spans
    of its call."""
    markers = sorted((s, e) for n, s, e in view.host if n == MARKER)
    outer = [r for r in recs if r.parent is None]
    if len(markers) != len(outer):
        return None
    offset = {r.call: (s + e) / 2 - r.clock_ns / 1e9
              for r, (s, e) in zip(outer, markers)}
    return sorted((r.host_start_ns / 1e9 + offset[r.call],
                   r.host_end_ns / 1e9 + offset[r.call])
                  for r in recs if r.name == call)
