"""Batches of frames through ``ofdm_tpu_torch.phy.rx.decode_frame``, closed
loop.

Each step decodes one batch of ``rows`` frames (the inputs in turn) and
copies its bytes, header and payload of every row, into host memory with
an asynchronous copy; up to ``in_flight`` steps are in flight, and a step
waits for the copy of the step ``in_flight`` before it.  A step counts
when its bytes are on the host: the window ends when the last step's are,
and ``decoded_samples_per_s`` is every step's samples over the window.
"""

from __future__ import annotations

import time

import torch

from ofdm_tpu_torch.phy.modulation import Modulation
from ofdm_tpu_torch.phy import rx
from rxbench import cell, trace, traffic
from rxbench.reference import receiver
from rxbench.wire import frame


def shapes(cfg: dict, tr: dict) -> dict:
    """The hand kernels' call shapes of a step (for the rooflines)."""
    gb, mod = cfg["guard_bands"], cfg["modulation"]
    nb = frame.n_data_blocks(cfg["payload_bytes"], mod, gb)
    carriers = len(frame.data_bins(gb))
    bins = carriers + (len(frame.PILOT_BINS) if gb else 0)
    rows = tr["rows"]
    need = (frame.N_SYNC_CHUNKS + nb) * frame.SYM_LEN
    return {"k1": {"rows": rows, "t": cfg["row_samples"], "need": need},
            "k2": {"rows": rows, "blocks": nb, "bins": bins,
                   "carriers": carriers,
                   "bits": frame.BITS_PER_SYMBOL[mod]},
            "derot": {"rows": rows, "blocks": nb, "n": frame.N_FFT,
                      "bins": bins}}


class Cell:
    def __init__(self, cfg: dict, tr: dict, seed: int, device: torch.device):
        self.device = device
        self.seed = seed
        self.tr = tr
        self.mod = cfg["modulation"]
        self.guard_bands = cfg["guard_bands"]
        self.nb = frame.n_data_blocks(cfg["payload_bytes"], self.mod,
                                      self.guard_bands)
        self.inputs = [traffic.frame_rows(cfg, tr, seed, i, device)
                       for i in range(tr["inputs"])]
        rows, t = self.inputs[0].shape
        carriers = len(frame.data_bins(self.guard_bands))
        bits = frame.BITS_PER_SYMBOL[self.mod]
        self.out_shape = (rows, self.nb * carriers * bits // 8)
        self.samples_per_step = rows * t
        self.shapes = shapes(cfg, tr)
        self.kw = dict(n_blocks=self.nb, guard_bands=self.guard_bands,
                       modulation=Modulation(self.mod))
        self.ring = [cell.pinned(self.out_shape, device)
                     for _ in range(tr["in_flight"])]
        self.kept = [cell.pinned(self.out_shape, device)
                     for _ in range(cell.PER_INPUT * len(self.inputs))]
        self.step_s = None

    def step(self, i: int) -> torch.Tensor:
        return rx.decode_frame(self.inputs[i % len(self.inputs)], **self.kw)

    def warm(self) -> None:
        """Every input once, then steps for the traffic's ``warm_seconds``."""
        cell.warm_for(self.step, len(self.inputs), self.tr["warm_seconds"],
                      self.device)
        self.step_s = cell.timed_steps(self.step, len(self.inputs), self.device)

    def window(self, seconds: float, traced: bool) -> cell.Window:
        n_in = len(self.inputs)
        plan = cell.sample_plan(self.seed, n_in, seconds / self.step_s)
        marks = [None] * len(self.ring)
        issue = 0.0
        i = 0
        cell.sync(self.device)
        with trace.span(trace.WINDOW_SPAN, traced):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                slot = i % len(self.ring)
                if marks[slot] is not None:
                    with trace.span("rxbench.wait", traced):
                        marks[slot].wait()
                a = time.perf_counter()
                with trace.span("rxbench.issue", traced):
                    out = self.step(i)
                issue += time.perf_counter() - a
                dest = self.kept[plan[i]] if i in plan else self.ring[slot]
                with trace.span("rxbench.fetch", traced):
                    dest.copy_(out, non_blocking=True)
                    marks[slot] = cell.Marker(self.device)
                last = dest
                i += 1
            cell.sync(self.device)
            t1 = time.perf_counter()
        answers = [(k % n_in, self.kept[s].numpy().copy())
                   for k, s in plan.items()
                   if k < i]
        answers.append(((i - 1) % n_in, last.numpy().copy()))
        return cell.Window(
            seconds=t1 - t0, steps=i, attempted=i, failed=0,
            metrics={"decoded_samples_per_s":
                     i * self.samples_per_step / (t1 - t0)},
            figures={"issue_ms_mean": 1e3 * issue / i}, answers=answers)

    def reference(self, i: int, dtype: torch.dtype, operands=None
                  ) -> torch.Tensor:
        return receiver.decode_rows(self.inputs[i], n_blocks=self.nb,
                                    modulation=self.mod,
                                    guard_bands=self.guard_bands, dtype=dtype,
                                    operands=operands)
