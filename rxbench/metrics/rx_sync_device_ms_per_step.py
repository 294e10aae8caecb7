"""Device ms a step inside the program's ``rx.sync`` spans (CUDA events):
the pad or ``pin_rowmajor`` step and the rows' sync and alignment into
planes, K1 ``sync_align`` on the batch cell's fused route."""

from rxbench.metrics import program_spans


def read(view):
    return program_spans.device_ms_per_step(view, "rx.sync")
