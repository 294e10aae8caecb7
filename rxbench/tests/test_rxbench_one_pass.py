"""K1's one-pass counter as the harness reads it: found among the launch
counters with no list, and its share of K1's calls as
``sync_one_pass_share``."""

from __future__ import annotations

import pytest

from rxbench import registry, run, trace


def test_launch_counters_find_the_one_pass_counter():
    from ofdm_tpu_torch.kernels import align
    found = run.launch_counters()
    assert found["sync_align_one_pass"] == align.sync_align_one_pass.launches
    assert found["sync_align"] == align.sync_align.launches


def counted(counters: dict) -> trace.View:
    return trace.View(device=[], host=[], start_s=0.0, end_s=0.01, steps=2,
                      counters=counters, figures={}, shapes={}, kind="cpu")


@pytest.mark.parametrize("counters, share", [
    ({"sync_align": 8, "sync_align_one_pass": 8}, 1.0),
    ({"sync_align": 8, "sync_align_one_pass": 4}, 0.5),
    ({"sync_align": 8, "sync_align_one_pass": 0}, 0.0),
    ({"sync_align": 0, "sync_align_one_pass": 0}, None),
    ({"sync_align": 8}, None),           # a program with no one-pass counter
    ({}, None),
], ids=["all", "half", "none", "no K1 call", "no counter", "no counters"])
def test_sync_one_pass_share_reads_the_counters(counters, share):
    got = registry.metric_reader("sync_one_pass_share").read(counted(counters))
    assert got == share


def test_sync_one_pass_share_is_reported_by_the_batch_cell():
    bench = registry.benchmark()
    names = [m["name"] for m in registry.cell_metrics(bench, "batch_qam64_b2048",
                                                      traced=True)]
    assert "sync_one_pass_share" in names
