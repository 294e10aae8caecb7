"""Device ms a step inside the program's ``rx.tail`` spans (CUDA events):
the channel estimate's gather at the used bins and K2 ``eq_demod_pack``."""

from rxbench.metrics import program_spans


def read(view):
    return program_spans.device_ms_per_step(view, "rx.tail")
