"""CUDA graphs of ``decode_frame``'s sync and front half (``phy/graphs.py``).

On the CPU: the key, the policy (the first call with a key runs eager, the
second captures, later ones replay; least recently used keys go first),
and that CPU calls never reach the graphs.  On a card (``gpu``): replayed
bytes against eager bytes on batches shaped like the benchmark's traffic
(fewer rows), results held across later calls, launch counts, when a call
captures, eviction, the TF32 guard and the layer spans of a replayed call.
JAX is not imported here, so on a host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs.py
"""

import inspect

import pytest
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.kernels import counters
from ofdm_tpu_torch.kernels.align import sync_align, sync_align_one_pass
from ofdm_tpu_torch.kernels.demod import eq_demod_pack
from ofdm_tpu_torch.kernels.derot import derot_dft
from ofdm_tpu_torch.obs import profiler
from ofdm_tpu_torch.ops.fft import _has_precision_api, set_full_fp32
from ofdm_tpu_torch.phy import graphs, rx

torch.set_num_threads(1)

COUNTERS = ("graph_captures", "graph_replays", "eager_calls")
SELECTORS = (4, True, ott.Modulation.QAM64, ott.DEFAULT_CONFIG, None, None,
             "coherent", "auto", "auto")


def counts(entry=rx.decode_frame) -> tuple:
    return tuple(getattr(entry, c) for c in COUNTERS)


# --- CPU: the key and the policy -------------------------------------------

def test_the_first_call_runs_eager_the_second_captures():
    cache = graphs.Cache(max_graphs=2)
    assert cache.find("a") is None and not cache.second_sight("a")
    assert cache.find("a") is None and cache.second_sight("a")
    cache.keep("a", "graphs of a")
    assert cache.find("a") == "graphs of a"
    assert "a" not in cache.seen
    # another key starts over
    assert cache.find("b") is None and not cache.second_sight("b")


def test_the_least_recently_used_graphs_go_first():
    cache = graphs.Cache(max_graphs=2)
    cache.keep("a", 1)
    cache.keep("b", 2)
    assert cache.find("a") == 1         # a is now the most recent
    cache.keep("c", 3)
    assert list(cache.graphs) == ["a", "c"] and cache.find("b") is None
    # an evicted key is new again: eager, then a capture
    assert not cache.second_sight("b") and cache.second_sight("b")


def test_keys_seen_once_are_bounded():
    cache = graphs.Cache(max_seen=3)
    for k in range(5):
        assert not cache.second_sight(k)
    assert list(cache.seen) == [2, 3, 4]
    assert not cache.second_sight(0)    # forgotten, so eager again


def test_a_key_names_the_same_call_alike():
    x = torch.zeros((4, 100), dtype=torch.complex64)
    assert graphs.key(x, 7, SELECTORS) == graphs.key(x[:], 7, SELECTORS)
    assert graphs.key(x, 7, SELECTORS) == graphs.key(x.view(4, 100), 7,
                                                     tuple(SELECTORS))


@pytest.mark.parametrize("change", ["address", "shape", "strides", "dtype",
                                    "stream", "n_blocks", "search_window",
                                    "derot_impl"])
def test_a_key_differs_with_each_part(change):
    x = torch.zeros((4, 100), dtype=torch.complex64)
    sel = list(SELECTORS)
    other = {"address": lambda: (x.clone(), 7, sel),
             "shape": lambda: (x[:2], 7, sel),
             "strides": lambda: (x[:, ::2], 7, sel),
             "dtype": lambda: (x.view(torch.float32), 7, sel),
             "stream": lambda: (x, 8, sel),
             "n_blocks": lambda: (x, 7, [5] + sel[1:]),
             "search_window": lambda: (x, 7, sel[:5] + [80] + sel[6:]),
             "derot_impl": lambda: (x, 7, sel[:-1] + ["stream"])}[change]
    y, stream, s = other()
    assert graphs.key(x, 7, SELECTORS) != graphs.key(y, stream, tuple(s))


def test_one_pool_per_device_stream_and_shape():
    x = torch.zeros((4, 100), dtype=torch.complex64)
    a = graphs.key(x, 7, SELECTORS)
    assert graphs.pool_key(a) == graphs.pool_key(
        graphs.key(x.clone(), 7, SELECTORS[:-1] + ("stream",)))
    assert graphs.pool_key(a) != graphs.pool_key(graphs.key(x, 8, SELECTORS))
    assert graphs.pool_key(a) != graphs.pool_key(graphs.key(x[:2], 7,
                                                            SELECTORS))


def test_the_batch_decoder_keys_every_selector():
    """Each entry point hands ``_decode_batch`` every selector it takes,
    and ``_decode_batch`` puts every one of them in the key."""
    def kwonly(fn):
        return [n for n, p in inspect.signature(fn).parameters.items()
                if p.kind is p.KEYWORD_ONLY]
    want = kwonly(rx._decode_batch)
    assert kwonly(rx.decode_frame) == kwonly(rx.decode_frame_planar) == want
    src = inspect.getsource(rx._decode_batch)
    keyed = src[src.index("selectors = ("):src.index("yr, yi, h_k, phase =")]
    assert all(name in keyed for name in want), keyed


def test_the_counters_cover_every_hand_kernel():
    names = {fn.__name__ for fn in counters().values()}
    assert {"sync_align", "planar_align", "pin_rowmajor", "sync_align_chunked",
            "sync_keys", "eq_demod_pack", "derot_dft"} <= names


def test_release_forgets_every_key():
    graphs._cache.seen["k"] = None
    graphs._cache.graphs["g"] = None
    graphs.release()
    assert not graphs._cache.seen and not graphs._cache.graphs


def _cpu_frames(rows=3, payload=64, cfo=True):
    data = torch.randint(0, 256, (rows, payload), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))
    tx = ott.encode(data, guard_bands=True, modulation=ott.Modulation.QAM64)
    x = ott.channel(tx, snr=45.0, timing_error=cfo,
                    generator=torch.Generator().manual_seed(4))
    nb = ott.n_data_blocks(payload, ott.Modulation.QAM64, True)
    return data, x, nb


@pytest.mark.parametrize("align_impl", ["auto", "xla", "chunked"])
@pytest.mark.parametrize("planar", [False, True], ids=["complex", "planar"])
def test_cpu_calls_never_reach_the_graphs(monkeypatch, align_impl, planar):
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached graphs.run")
    monkeypatch.setattr(graphs, "run", refuse)
    data, x, nb = _cpu_frames()
    entry = rx.decode_frame_planar if planar else rx.decode_frame
    if planar:
        x = torch.stack([x.real, x.imag], dim=1)
    before = counts(entry)
    kw = dict(n_blocks=nb, guard_bands=True, modulation=ott.Modulation.QAM64,
              align_impl=align_impl)
    outs = [entry(x, **kw) for _ in range(3)]
    assert counts(entry) == before == (0, 0, 0)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0][:, 16:16 + data.shape[1]], data)


# --- on a card ---------------------------------------------------------------

ROWS = 64
PAYLOAD = 8192
MOD = ott.Modulation.QAM64


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3c runs these "
                    "checks at the batch benchmark's shape")
    set_full_fp32()
    graphs.release()
    return torch.device("cuda")


def _batches(dev, n=4, rows=ROWS):
    """The benchmark's traffic in small: ``n`` batches of QAM64 frames with
    guard bands, padded to 19,120 samples; batch 0 clean at SNR 45, the
    others at SNR 35-45 with the channel's timing error and CFO.  Returns
    (payloads, batches, kw)."""
    cfg = ott.DEFAULT_CONFIG
    nb = ott.n_data_blocks(PAYLOAD, MOD, True)
    t = cfg.sync_len + cfg.sym_len + nb * cfg.sym_len
    gen = torch.Generator(dev).manual_seed(11)
    data, xs = [], []
    for i in range(n):
        d = torch.randint(0, 256, (rows, PAYLOAD), generator=gen, device=dev,
                          dtype=torch.uint8)
        x = ott.channel(ott.encode(d, guard_bands=True, modulation=MOD),
                        snr=45.0 if i == 0 else 30.0 + 5 * i,
                        timing_error=i > 0, generator=gen)
        data.append(d)
        xs.append(torch.nn.functional.pad(x, (0, t - x.shape[-1])))
    return data, xs, dict(n_blocks=nb, guard_bands=True, modulation=MOD)


def _launches():
    return (sync_align.launches, derot_dft.launches, eq_demod_pack.launches)


def _delta(fn):
    torch.cuda.synchronize()
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(a - b for a, b in zip(_launches(), before))


@pytest.mark.gpu
def test_replayed_bytes_equal_eager_bytes_on_every_batch():
    dev = _cuda()
    data, xs, kw = _batches(dev)
    before = counts()
    eager = [rx.decode_frame(x, **kw) for x in xs]
    assert counts() == (before[0], before[1], before[2] + 4)
    for rnd in range(3):        # a capture each, then replays
        for x, want in zip(xs, eager):
            assert torch.equal(rx.decode_frame(x, **kw), want)
    assert counts() == (before[0] + 4, before[1] + 8, before[2] + 4)
    assert torch.equal(eager[0][:, 16:16 + PAYLOAD], data[0])


@pytest.mark.gpu
@pytest.mark.parametrize("route", [
    "planar", "planar strided", "xla", "bf16", "fft", "conv", "stream derot",
    "complex128", "one row"])
def test_replayed_bytes_equal_eager_bytes_on_every_route(route):
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=16)
    entry = rx.decode_frame
    if route in ("planar", "planar strided"):
        entry = rx.decode_frame_planar
        x = torch.stack([x.real, x.imag], dim=1) if route == "planar" \
            else torch.view_as_real(x).transpose(1, 2)
    elif route == "complex128":
        x = x.to(torch.complex128)
    elif route == "one row":
        x = x[3]
    else:
        kw |= {"xla": dict(align_impl="xla"),
               "bf16": dict(sync_dtype=torch.bfloat16),
               "fft": dict(sync_dtype="fft"),
               "conv": dict(sync_dtype="conv"),
               "stream derot": dict(derot_impl="stream")}[route]
    before = counts(entry)
    outs = [entry(x, **kw) for _ in range(4)]
    assert counts(entry) == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
def test_the_chunked_route_runs_eager():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=16)
    before = counts()
    outs = [rx.decode_frame(x, align_impl="chunked", **kw) for _ in range(3)]
    assert counts() == (before[0], before[1], before[2] + 3)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
def test_a_held_result_outlives_later_calls():
    dev = _cuda()
    _, xs, kw = _batches(dev, n=2)
    for _ in range(2):
        rx.decode_frame(xs[0], **kw)
    held = rx.decode_frame(xs[0], **kw)             # a replay
    copy = held.clone()
    later = [rx.decode_frame(x, **kw) for x in xs * 3]
    torch.cuda.synchronize()
    assert torch.equal(held, copy)
    assert all(o.data_ptr() != held.data_ptr() for o in later)


@pytest.mark.gpu
def test_a_replay_counts_the_launches_an_eager_call_makes():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1)
    n = [_delta(lambda: rx.decode_frame(x, **kw))[1] for _ in range(4)]
    assert counts()[0] >= 1 and n == [(1, 1, 1)] * 4


@pytest.mark.gpu
def test_a_replay_takes_k1_in_one_pass_as_the_eager_call_does():
    """At 256 rows of the benchmark's 19,120 samples K1 runs as one kernel
    (``sync_align_one_pass``): the capture holds it, every replay counts
    it, and the replayed bytes equal the eager call's."""
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=256)
    before = counts()
    outs, one_pass = [], []
    for _ in range(4):            # eager, capture, replay, replay
        n = sync_align_one_pass.launches
        outs.append(rx.decode_frame(x, **kw))
        torch.cuda.synchronize()
        one_pass.append(sync_align_one_pass.launches - n)
    assert counts() == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert one_pass == [1] * 4
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
def test_a_call_captures_second_never_under_the_profiler():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=16)
    before = counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(3):
            rx.decode_frame(x, **kw)
    assert counts() == (before[0], before[1], before[2] + 3)
    rx.decode_frame(x, **kw)
    assert counts() == (before[0], before[1], before[2] + 4)
    rx.decode_frame(x, **kw)
    assert counts() == (before[0] + 1, before[1], before[2] + 4)
    # the same samples under another stride or selector is another key
    for y, extra in ((x[:, :-80], {}), (x, dict(search_window=400)),
                     (x, dict(cfo_estimator="reference"))):
        rx.decode_frame(y, **kw, **extra)
        assert counts()[0] == before[0] + 1
    # and so is another stream
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        rx.decode_frame(x, **kw)
    torch.cuda.current_stream().wait_stream(s)
    assert counts() == (before[0] + 1, before[1], before[2] + 8)


@pytest.mark.gpu
def test_a_call_inside_a_capture_runs_eager():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=16)
    want = [rx.decode_frame(x, **kw) for _ in range(3)][-1]
    for seen in ("with graphs", "seen once"):
        if seen == "seen once":
            graphs.release()
            rx.decode_frame(x, **kw)
        before = counts()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = rx.decode_frame(x, **kw)
        g.replay()
        assert counts() == (before[0], before[1], before[2] + 1), seen
        assert torch.equal(out, want), seen


@pytest.mark.gpu
def test_the_least_recently_used_graphs_are_evicted(monkeypatch):
    dev = _cuda()
    monkeypatch.setattr(graphs._cache, "max_graphs", 2)
    _, xs, kw = _batches(dev, n=3, rows=16)
    want = [rx.decode_frame(x, **kw) for x in xs]
    for x in xs:
        rx.decode_frame(x, **kw)                # three captures, one evicted
    assert len(graphs._cache.graphs) == 2
    before = counts()
    assert torch.equal(rx.decode_frame(xs[0], **kw), want[0])
    assert counts() == (before[0], before[1], before[2] + 1)
    for x, w in zip(xs[1:], want[1:]):
        assert torch.equal(rx.decode_frame(x, **kw), w)
    assert counts() == (before[0], before[1] + 2, before[2] + 1)


@pytest.mark.gpu
def test_tf32_still_raises_on_a_replayed_key():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1, rows=16)
    for _ in range(3):
        rx.decode_frame(x, **kw)
    try:
        if _has_precision_api():
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        else:
            torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            rx.decode_frame(x, **kw)
    finally:
        set_full_fp32()


@pytest.mark.gpu
def test_a_replayed_call_still_records_its_layer_spans():
    dev = _cuda()
    _, (x,), kw = _batches(dev, n=1)
    want = [rx.decode_frame(x, **kw) for _ in range(2)][-1]
    before = counts()
    profiler.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]):
        outs = [rx.decode_frame(x, **kw) for _ in range(3)]
        recs = profiler.records()
    assert counts() == (before[0], before[1] + 3, before[2])
    assert all(torch.equal(o, want) for o in outs)
    for name in ("rx.decode_frame", "rx.sync", "rx.front", "rx.tail"):
        ms = [r.device_ms for r in recs if r.name == name]
        assert len(ms) == 3 and all(m is not None and m > 0 for m in ms), \
            (name, ms)
    profiler.reset()
