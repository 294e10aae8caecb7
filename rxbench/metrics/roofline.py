"""A hand kernel's share of its bytes roofline over the traced window:
100 x (calls x bound seconds of one call) / (the kernel's device seconds),
None where the kernel did not run or the card has no entry in the peaks."""

from rxbench import peaks


def share(view, kernel_names: tuple, counter: str, call_bytes: int):
    calls = view.counters.get(counter, 0)
    t = view.seconds(lambda n: any(k in n for k in kernel_names))
    bw = peaks.hbm_bytes_per_s(view.kind)
    if not calls or t <= 0 or bw is None:
        return None
    return 100.0 * calls * call_bytes / bw / t
