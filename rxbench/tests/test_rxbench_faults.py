"""A run with the timed path broken underneath reads ``correct`` false,
for each fault a cell of this kind can have; the unbroken run reads true.
The runner's look for a card is skipped (the CPU runs the program's plain
kernels); the rest of a run is driven as on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ofdm_tpu_torch.phy.rx as rx
import ofdm_tpu_torch.phy.streaming as streaming
from rxbench import run


def altered(out):
    """An answer altered where it is produced: row 0's bytes inverted."""
    out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
    out[0] ^= 0xFF
    return out


def half_left_out(out):
    """Half of the batch left out: its rows come back empty."""
    out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
    out[out.shape[0] // 2:] = 0
    return out


class Stale:
    """A step that returns its state unchanged: every call answers with
    the first call's bytes."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None:
            self.first = out
        return self.first


FAULTS = {"none": None, "altered": altered, "half_left_out": half_left_out,
          "stale": Stale}


def broken(fn, fault, stream: bool):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        if stream:
            return fault(out[0]), out[1]
        return fault(out)
    return call


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name,stream", [
    ("batch_qam64_b2048", False), ("stream_hamming_qam64_f2048", True),
    ("live_stream_hamming_qam64_f2048", True)])
def test_a_broken_timed_path_reads_not_correct(tiny, bench, monkeypatch,
                                               fault, name, stream):
    f = FAULTS[fault]
    if f is Stale:
        f = Stale()
    if f is not None:
        if stream:
            monkeypatch.setattr(streaming, "decode_regular",
                                broken(streaming.decode_regular, f, True))
        else:
            monkeypatch.setattr(rx, "decode_frame",
                                broken(rx.decode_frame, f, False))
    result = run.run(bench, name, 77, 0.3, False,
                     torch.device("cpu"), data=tiny)
    assert result["correct"] is (fault == "none"), result["check"]
    if fault != "none":
        assert result["check"]["byte_mismatch_ppm"]["value"] > 0
    assert np.isfinite(result["check"]["byte_mismatch_ppm"]["value"])
