"""What every driver shares: the measured window's result, the sample of
answers that are checked, and the device's clock and copies.

A driver module defines ``Cell(cfg, traffic, seed, device)`` with
``shapes`` (the hand kernels' call shapes, for the rooflines),
``warm()``, ``window(seconds, traced) -> Window`` and
``reference(i, dtype, operands=None)`` (the expected answer to input i,
by the plain receiver).  ``Window.answers`` holds (input index, answer)
pairs: a sample of the window's answers drawn from the seed, each input
at least twice where the window ran that long, and the window's last
answer.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

PER_INPUT = 2       # sampled answers of each input
SAMPLE_SPAN = 0.8   # sampled steps lie in the first 80% of those expected


@dataclasses.dataclass
class Window:
    seconds: float      # host clock, first issue to the last answer
    steps: int          # calls of the entry point
    attempted: int
    failed: int
    metrics: dict       # end-to-end metrics by name
    figures: dict       # host-clock figures for the per-layer readers
    answers: list       # (input index, numpy answer)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample_plan(seed: int, inputs: int, expected_steps: float) -> dict:
    """{step index: sample slot}: PER_INPUT steps of each input, drawn from
    the seed among the first SAMPLE_SPAN of the steps a window is expected
    to run."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 63), 7]))
    span = max(1, int(SAMPLE_SPAN * expected_steps) // inputs)
    plan = {}
    for b in range(inputs):
        picks = rng.choice(span, size=min(PER_INPUT, span), replace=False)
        for k in sorted(int(p) for p in picks):
            plan[k * inputs + b] = len(plan)
    return plan


def warm_for(step, inputs: int, seconds: float, device: torch.device) -> None:
    """``step(i)`` for every input, then on until ``seconds`` have passed;
    waits for the device at the end."""
    t0 = time.perf_counter()
    i = 0
    while i < inputs or time.perf_counter() - t0 < seconds:
        step(i)
        i += 1
    sync(device)


def timed_steps(step, n: int, device: torch.device) -> float:
    """Seconds per step of ``step(i)`` for i < n, each waited for."""
    t = time.perf_counter()
    for i in range(n):
        step(i)
        sync(device)
    return (time.perf_counter() - t) / n


def pinned(shape, device: torch.device) -> torch.Tensor:
    """A host buffer of uint8 that copies from the device can fill
    asynchronously (pinned where the device is a card)."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


class Marker:
    """An event on the current stream of a card, or nothing on the CPU,
    whose work is then already done."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

