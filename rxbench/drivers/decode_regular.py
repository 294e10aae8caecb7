"""Streams of frames at a fixed spacing through
``ofdm_tpu_torch.phy.streaming.decode_regular``, one caller, closed loop.

Each call decodes one whole stream (the inputs in turn) with the global
sync, K3's frame cut, the matrix-derot tail and the code's FEC on the
card, and returns when the user bytes are on the host.
``decoded_samples_per_s`` is every call's stream samples over the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ofdm_tpu_torch.phy.modulation import Modulation
from ofdm_tpu_torch.phy import streaming
from rxbench import cell, trace, traffic
from rxbench.reference import receiver
from rxbench.wire import frame


def shapes(cfg: dict, tr: dict) -> dict:
    """The hand kernels' call shapes of a call (for the rooflines)."""
    gb, mod = cfg["guard_bands"], cfg["modulation"]
    nb = frame.n_data_blocks(traffic.payload_len(cfg), mod, gb)
    carriers = len(frame.data_bins(gb))
    bins = carriers + (len(frame.PILOT_BINS) if gb else 0)
    rows = tr["frames"]
    return {"k3": {"rows": rows, "need": traffic.frame_len(cfg)},
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
        self.fec = cfg.get("fec")
        self.user = cfg["user_bytes"] if self.fec else cfg["payload_bytes"]
        self.plen = traffic.payload_len(cfg)
        self.nb = frame.n_data_blocks(self.plen, self.mod, self.guard_bands)
        self.flen = traffic.frame_len(cfg)
        self.frames = tr["frames"]
        self.inputs = [traffic.stream(cfg, tr, seed, i, device)
                       for i in range(tr["inputs"])]
        self.shapes = shapes(cfg, tr)
        self.kw = dict(n_frames=self.frames, spacing=self.flen,
                       payload_len=self.plen, guard_bands=self.guard_bands,
                       modulation=Modulation(self.mod), fec=self.fec,
                       data_len=self.user, resync=False)
        # the sampled answers are copied into buffers of the harness, so the
        # program's own arrays are freed as a caller frees them
        self.kept = [np.zeros((self.frames, self.user), np.uint8)
                     for _ in range(cell.PER_INPUT * len(self.inputs))]
        self.step_s = None

    def step(self, i: int):
        """One call; its user bytes, numpy [frames, user bytes]."""
        return streaming.decode_regular(self.inputs[i % len(self.inputs)],
                                        **self.kw)[0]

    def warm(self) -> None:
        """Every input once, then calls for the traffic's ``warm_seconds``:
        a call's fetch into fresh host memory runs ~35% slower for the
        first 6-9 s of calls in a process, then steadies."""
        cell.warm_for(self.step, len(self.inputs), self.tr["warm_seconds"],
                      self.device)
        self.step_s = cell.timed_steps(self.step, len(self.inputs), self.device)

    def keep(self, plan: dict, i: int, out, answers: list) -> None:
        if i in plan:
            np.copyto(self.kept[plan[i]], out)
            answers.append((i % len(self.inputs), plan[i]))

    def collected(self, answers: list, last) -> list:
        """The kept answers as (input, array) pairs, and the last one."""
        return [(i, self.kept[s].copy()) for i, s in answers] + [last]

    def window(self, seconds: float, traced: bool) -> cell.Window:
        n_in = len(self.inputs)
        plan = cell.sample_plan(self.seed, n_in, seconds / self.step_s)
        answers = []
        i = 0
        with trace.span(trace.WINDOW_SPAN, traced):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with trace.span("rxbench.call", traced):
                    out = self.step(i)
                self.keep(plan, i, out, answers)
                i += 1
            t1 = time.perf_counter()
        samples = self.inputs[0].shape[-1]
        return cell.Window(
            seconds=t1 - t0, steps=i, attempted=i, failed=0,
            metrics={"decoded_samples_per_s": i * samples / (t1 - t0)},
            figures={}, answers=self.collected(answers, ((i - 1) % n_in, out)))

    def reference(self, i: int, dtype: torch.dtype, operands=None
                  ) -> torch.Tensor:
        raw = receiver.decode_stream(self.inputs[i], n_frames=self.frames,
                                     spacing=self.flen, n_blocks=self.nb,
                                     modulation=self.mod,
                                     guard_bands=self.guard_bands, dtype=dtype,
                                    operands=operands)
        payload = raw[:, frame.HEADER_LEN:frame.HEADER_LEN + self.plen]
        if self.fec == "hamming":
            return receiver.hamming_decode(payload, self.user)
        return payload
