"""The share of K1 ``sync_align`` calls over the traced window that took
its one-pass kernel (``sync_align_one_pass``), by the program's launch
counters; None where K1 did not run or the program has no one-pass
counter."""


def read(view):
    calls = view.counters.get("sync_align", 0)
    one_pass = view.counters.get("sync_align_one_pass")
    if not calls or one_pass is None:
        return None
    return one_pass / calls
