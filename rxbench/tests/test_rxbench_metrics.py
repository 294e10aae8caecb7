"""The byte counts of the hand kernels, pinned at the cells' shapes, and
the per-layer readers on a made-up trace."""

from __future__ import annotations

import pytest

from rxbench import registry, trace
from rxbench.metrics import kernel_bytes
from conftest import with_streams

KIND = "NVIDIA H100 80GB HBM3"
DEROT = {"rows": 2048, "blocks": 228, "n": 64, "bins": 52}


def cell_shapes(name: str) -> dict:
    w = registry.cell(with_streams(registry.benchmark()), name)
    tr = registry.traffic(w["traffic"])
    return registry.driver(tr["driver"]).shapes(registry.config(w["config"]),
                                                tr)


def test_shapes_of_the_batch_cell():
    s = cell_shapes("batch_qam64_b2048")
    assert s["k1"] == {"rows": 2048, "t": 19120, "need": 19040}
    assert s["k2"] == {"rows": 2048, "blocks": 228, "bins": 52,
                       "carriers": 48, "bits": 6}
    # 313,262,080 in + 640 template + 311,951,360 planes + 8,192 offsets
    assert kernel_bytes.k1_sync_align(**s["k1"]) == 625_222_272
    # 194,248,704 planes + 851,968 channel + 8,192 CFO + 16,809,984 bytes out
    assert kernel_bytes.k2_eq_demod_pack(**s["k2"]) == 211_918_848
    assert s["derot"] == DEROT
    # 2 x 119,537,664 planes + 194,248,704 product + 8,192 CFO
    assert kernel_bytes.derot_dft(**s["derot"]) == 433_332_224


def test_shapes_of_the_stream_cell():
    s = cell_shapes("stream_hamming_qam64_f2048")
    assert s["k3"] == {"rows": 2048, "need": 19040}
    assert s["k2"]["blocks"] == 228 and s["k2"]["rows"] == 2048
    # 311,951,360 windows read + 16,384 offsets + 311,951,360 planes
    assert kernel_bytes.k3_planar_align(**s["k3"]) == 623_919_104
    assert kernel_bytes.k2_eq_demod_pack(**s["k2"]) == 211_918_848
    assert s["derot"] == DEROT


def view(**kw) -> trace.View:
    """Two steps in a 10 ms window: K1's two kernels 1 ms each step, a GEMM
    2 ms, K2 0.5 ms, a 0.4 ms fetch; the device idle 2.2 ms."""
    items = []
    for k, t in enumerate((0.0, 0.005)):
        items += [("void corr_argmax_kernel<true>(...)", t, t + 0.0006),
                  ("window_kernel(...)", t + 0.0006, t + 0.001),
                  ("sm90_xmma_gemm_f32f32", t + 0.001, t + 0.003),
                  ("eq_demod_pack_kernel", t + 0.003, t + 0.0035),
                  ("Memcpy DtoH (Device -> Pinned)", t + 0.0035, t + 0.0039)]
    base = dict(device=items, host=[("rxbench.issue", 0.0, 0.004)],
                start_s=0.0, end_s=0.01, steps=2,
                counters={"sync_align": 2, "eq_demod_pack": 2,
                          "planar_align": 0},
                figures={"issue_ms_mean": 1.5},
                shapes={"k1": {"rows": 2048, "t": 19120, "need": 19040},
                        "k2": {"rows": 2048, "blocks": 228, "bins": 52,
                               "carriers": 48, "bits": 6}},
                kind=KIND)
    base.update(kw)
    return trace.View(**base)


def read(name, v):
    return registry.metric_reader(name).read(v)


def test_readers_on_a_made_up_trace():
    v = view()
    assert read("launches_per_step", v) == 5
    assert read("torch_ops_device_ms_per_step", v) == pytest.approx(2.0)
    assert read("d2h_device_ms_per_step", v) == pytest.approx(0.4)
    assert read("device_idle_share", v) == pytest.approx(0.22)
    assert read("host_issue_ms_per_step.batch", v) == 1.5
    bound_k1 = 625_222_272 / 3.35e12
    assert read("sync_align_roofline", v) == pytest.approx(
        100 * bound_k1 / 0.001)
    assert read("eq_demod_pack_roofline", v) == pytest.approx(
        100 * 211_918_848 / 3.35e12 / 0.0005)


def test_readers_find_nothing_to_read():
    v = view(shapes={}, counters={}, figures={})
    for name in ("sync_align_roofline", "planar_align_roofline",
                 "eq_demod_pack_roofline", "host_issue_ms_per_step.batch"):
        assert read(name, v) is None
    assert read("sync_align_roofline", view(kind="a card not in the table")) \
        is None


def test_busy_time_counts_overlaps_once():
    v = view(device=[("a", 0.0, 0.004), ("b", 0.002, 0.006),
                     ("c", 0.008, 0.009)])
    assert v.busy_s() == pytest.approx(0.007)


def test_breakdown_names_the_host_in_each_gap():
    v = view(host=[("rxbench.window", 0.0, 0.01),
                   ("rxbench.wait", 0.0039, 0.005),
                   ("cudaEventSynchronize", 0.00391, 0.00499)])
    b = trace.breakdown(v)
    assert len(b["device_ops"]) == 5
    assert b["device_ops"][0][0] == "sm90_xmma_gemm_f32f32"
    assert b["device_ops"][0][1] == pytest.approx(0.004)
    names = dict(b["idle_gaps"])
    assert names["rxbench.wait/cudaEventSynchronize"] == pytest.approx(0.0011)
    assert sum(names.values()) == pytest.approx(0.0022)


def test_derot_dft_roofline_on_a_made_up_trace():
    # two calls of 0.165 ms against a bound of 0.1294 ms: 78.4%
    items = [("void derot_dft_kernel<8>(float const*, ...)", t, t + 0.000165)
             for t in (0.0045, 0.0095)]
    v = view(device=view().device + items,
             counters={"derot_dft": 2, "sync_align": 2},
             shapes={"derot": DEROT})
    assert read("derot_dft_roofline", v) == pytest.approx(
        100 * 433_332_224 / 3.35e12 / 0.000165)
    assert 78 < read("derot_dft_roofline", v) < 79
    assert read("derot_dft_roofline", view(device=v.device,
                                           counters=v.counters)) is None
    assert read("derot_dft_roofline", view(device=v.device,
                                           shapes=v.shapes)) is None
    assert read("derot_dft_roofline", view(device=v.device,
                                           counters=v.counters,
                                           shapes=v.shapes,
                                           kind="a card not in the table")) \
        is None
