"""Device ms a step inside the program's ``rx.front`` spans (CUDA events):
the CFO estimate, the channel estimate and the derotating DFT GEMM."""

from rxbench.metrics import program_spans


def read(view):
    return program_spans.device_ms_per_step(view, "rx.front")
