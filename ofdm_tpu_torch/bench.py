"""The port's benchmark: the root ``bench.py``'s configs 2, 4 and 5 on one card.

    python -m ofdm_tpu_torch.bench [--seed 0] [--only headline]

Runs each configuration through the port's entry points at ``bench.py``'s
sizes on the card (``--device`` defaults to cuda and raises without one),
checks every output in the same process, and prints one JSON line, its
last line, in ``bench.py``'s layout.  A failed check raises: the command
exits non-zero and prints no number.  ``--device cpu`` and the size flags
(``--batch``, ``--payload``, ``--ham-frames``, ``--srv-frames``,
``--srv-distinct``, ``--srv-rounds``, ``--steps``) exist for the tests:

    python -m ofdm_tpu_torch.bench --device cpu --batch 4 --payload 64 \\
        --ham-frames 2 --srv-frames 2 --srv-distinct 2 --srv-rounds 2 --steps 11

The workloads come from ``--seed``; seed 0 draws ``bench.py``'s payload
bytes and pixels.  The channel's noise comes from ``torch.Generator``s, so it
differs from ``bench.py``'s ``jax.random`` draws and between devices.

- The headline, config 2 (bench.py:39-42, 115-258): ``decode_frame`` on 256
  QAM64 frames of 8,192 payload bytes with guard bands, rows of 19,120
  samples, cycling through 4 batches (batch 0 clean, batches 1-3 with the
  channel's timing error); ``decode_frame_planar`` on contiguous f32
  [256, 2, 19,120] planes of the same batches; 5 blocking calls, each
  ending in a fetch.  Gate: 0 payload byte errors on the clean batch.
- Config 4 (bench.py:44-47, 261-389): ``decode_regular`` presync with the
  Hamming(7,4) decode on the card, 256 frames of 4,680 user bytes in a
  4,874,320-sample stream, complex [T] and contiguous planar [2, T], two
  streams.  Each step ends in the fetch of the user bytes.  Gate: the user
  bytes equal the sent bytes.
- Config 5 (bench.py:49-55, 392-611): ``io.serving`` with 390 RS-coded
  24 x 24 id images a buffer, 4 distinct buffers (odd ones with CFO), 4 in
  flight, 100 buffers in three modes: ``d2h`` (``serve``: async fetch, RS
  and colorspace on the host), ``device_resident`` (``serve_step`` per
  buffer, one synchronize at the end) and ``planar`` (``serve`` over
  [2, T] planes).  Gate: in every mode, every buffer's payload rows equal
  the RS code bytes that were sent (RS would hide a few wrong bytes), its
  images equal the sent pixels, and RS decodes every frame, on the native
  codec.

Step times come from CUDA events recorded around each of N steps issued
back to back, read after one synchronize at the end, so that a step's
enqueue overlaps the previous step's device work; each is reported as its
median and the highest percentile with at least 10 samples beyond it,
with N.  Device busy time comes from a separate pass under torch.profiler;
the timed runs are not traced.  Launches per step come from the kernel
wrappers' counters.  ``chip_smoke.py`` imports the timers.

Not carried over from ``bench.py``: the carry chain that defeats a TPU
runtime's result cache (eager PyTorch has none), the retries and their
thresholds, the attempts file, the compile cache, the layout pins, and
``vs_baseline`` against a target set for a TPU slice.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .apps.common import add_device_arg, resolve_device
from .config import DEFAULT_CONFIG as CFG
from .core import native
from .core.transfer import fetch_async
from .fec import reed_solomon as rs
from .io import serving
from .kernels import _build
from .kernels.align import pin_rowmajor, planar_align, sync_align, sync_keys
from .kernels.chain import sync_align_chunked
from .kernels.demod import eq_demod_pack
from .packets.colors import id_to_rgb
from .packets.header import HEADER_LEN
from .phy.channel import channel
from .phy.modulation import Modulation
from .phy.rx import decode_frame, decode_frame_planar
from .phy.streaming import coded_len, decode_regular
from .phy.tx import encode, encode_hamming, n_data_blocks

MOD = Modulation.QAM64
SNR = 45.0                  # bench.py:126, 280, 432
# config 2, the headline (bench.py:39-42)
BATCH = 256
PAYLOAD = 8192
N_INPUTS = 4
STEPS = 100                 # bench.py:42; config 4 too (bench.py:47 timed 30)
WARMUP = 3
LATENCY_CALLS = 5           # bench.py:244
# config 4, Hamming-coded streaming (bench.py:44-46, 276)
HAM_FRAMES = 256
HAM_DATA_BYTES = 4680
HAM_STREAMS = 2
# config 5, serving (bench.py:50-53); 25 rounds where bench.py ran 3, so
# that 100 buffers give a p90
SRV_DISTINCT = 4
SRV_FRAMES = 390
SRV_ROUNDS = 25
SRV_IN_FLIGHT = 4
TOP_ITEMS = 5

KERNELS = {"sync_align": sync_align, "eq_demod_pack": eq_demod_pack,
           "planar_align": planar_align,
           "sync_align_chunked": sync_align_chunked,
           "pin_rowmajor": pin_rowmajor, "sync_keys": sync_keys}


class GateError(RuntimeError):
    """An output differs from what was sent: no number is reported."""


def gate(cond: bool, msg: str) -> None:
    if not cond:
        raise GateError(msg)


# --- timers -------------------------------------------------------------------

def tail_percentile(n: int) -> int | None:
    """The highest whole percentile q whose nearest-rank value (the
    ceil(q n / 100)-th smallest of n) has at least 10 samples beyond it:
    floor(100 (n - 10) / n), 90 at n = 100; None below 11 samples."""
    return 100 * (n - 10) // n if n > 10 else None


def summary(ms: list[float]) -> dict:
    """Median and tail of a list of times in ms, with their count n."""
    s = sorted(ms)
    out = {"n": len(s), "median_ms": statistics.median(s)}
    q = tail_percentile(len(s))
    if q is not None:
        out[f"p{q}_ms"] = s[-(-q * len(s) // 100) - 1]
    return out


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches_per(n: int) -> dict:
    """Each launched kernel's count since ``reset_launches`` over n steps
    (the wrappers count CUDA launches only)."""
    return {name: k.launches // n if k.launches % n == 0 else k.launches / n
            for name, k in KERNELS.items() if k.launches}


def timed(step, n: int, dev: torch.device, warmup: int = WARMUP) -> dict:
    """``step(i)`` for i < warmup, then for i < n, timed.  On CUDA, events
    are recorded on the current stream around each step and the host never
    waits between steps: the times are read after one synchronize at the
    end.  On the CPU, the host clock around each step.  Returns the times'
    ``summary`` with the wall time over all n steps / n (``wall_ms``), and
    the kernel launches per timed step."""
    for i in range(warmup):
        step(i)
    cuda = dev.type == "cuda"
    if cuda:
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        torch.cuda.synchronize(dev)
    times = []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(n):
        if cuda:
            marks[i][0].record()
            step(i)
            marks[i][1].record()
        else:
            t = time.perf_counter()
            step(i)
            times.append((time.perf_counter() - t) * 1e3)
    if cuda:
        torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / n
    if cuda:
        times = [a.elapsed_time(b) for a, b in marks]
    return {"ms_per_step": {**summary(times), "wall_ms": wall},
            "launches": launches_per(n)}


def median_s(fn, reps: int = 10) -> float:
    """Median host-clock seconds of ``fn`` (which ends in a wait), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def device_ms(fn, sessions: int = 15) -> dict:
    """Device time of each kernel one call of ``fn`` runs, from torch.profiler
    (CUPTI): one call per profiler session, and the session whose total is
    the median.  (Sessions of many calls were seen to lose events.)  Raises
    if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per_kernel: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        runs.append(per_kernel)
    runs.sort(key=lambda d: sum(d.values()))
    median = runs[len(runs) // 2]
    if sum(median.values()) <= 0:
        raise RuntimeError("torch.profiler saw no device time")
    return median


def profiled(fn, dev: torch.device) -> dict:
    """Device busy ms of one call of ``fn`` and its top device items; None
    and [] off CUDA, where there is no device to trace."""
    if dev.type != "cuda":
        return {"device_busy_ms": None, "top_device_items": []}
    items = device_ms(fn)
    top = sorted(items.items(), key=lambda kv: -kv[1])[:TOP_ITEMS]
    return {"device_busy_ms": sum(items.values()),
            "top_device_items": [{"name": k[:120], "ms": v} for k, v in top]}


def idle_share(busy_ms: float | None, step_ms: float):
    """1 - device busy / step time: how far the host holds the card back."""
    return None if busy_ms is None else 1.0 - busy_ms / step_ms


def peak_memory(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def reset_peak_memory(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def card(index: int = 0) -> str:
    """The card's ``name, power limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[index]


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "name": None, "power_limit": None, "count": 1}
    name, limit = card(dev.index).rsplit(", ", 1)
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


# --- workloads ----------------------------------------------------------------

def generator(dev: torch.device, *key: int) -> torch.Generator:
    """A generator on ``dev`` seeded from the integers ``key``."""
    state = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return torch.Generator(dev).manual_seed(int(state))


def headline_payloads(seed: int, batch: int = BATCH,
                      payload: int = PAYLOAD) -> list[np.ndarray]:
    """N_INPUTS batches of uint8 [batch, payload], drawn in bench.py's order
    (bench.py:120-123)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, payload), dtype=np.uint8)
            for _ in range(N_INPUTS)]


def headline_workload(seed: int, batch: int, payload: int, dev: torch.device):
    """(payloads, received batches complex64 [batch, frame] on ``dev``, data
    blocks): QAM64 with guard bands through the channel at SNR 45, batch i
    from a generator seeded with (seed, i), with the timing error for i > 0;
    rows zero-padded to sync + one spare symbol + the data blocks
    (bench.py:117-130: 19,120 samples at 8,192 bytes)."""
    nb = n_data_blocks(payload, MOD, True)
    frame = CFG.sync_len + (nb + 1) * CFG.sym_len
    datas = headline_payloads(seed, batch, payload)
    rxs = []
    for i, d in enumerate(datas):
        tx = encode(d, guard_bands=True, modulation=MOD, device=dev)
        rx = channel(tx, snr=SNR, timing_error=i > 0,
                     generator=generator(dev, seed, i))
        rxs.append(torch.nn.functional.pad(rx, (0, frame - rx.shape[-1])))
    return datas, rxs, nb


def hamming_payloads(seed: int, n_frames: int = HAM_FRAMES) -> list[np.ndarray]:
    """HAM_STREAMS batches of user bytes uint8 [n_frames, 4,680], drawn in
    bench.py's order (bench.py:274-277)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n_frames, HAM_DATA_BYTES), dtype=np.uint8)
            for _ in range(HAM_STREAMS)]


def hamming_geometry() -> tuple[int, int, int]:
    """(wire bytes, data blocks, frame samples) of config 4: (8,190, 228,
    19,040)."""
    plen = coded_len(HAM_DATA_BYTES, "hamming")
    nb = n_data_blocks(plen, MOD, True)
    return plen, nb, CFG.sync_len + nb * CFG.sym_len


def hamming_workload(seed: int, n_frames: int, dev: torch.device):
    """(user bytes, complex64 streams [n_frames * 19,040 + 80] on ``dev``):
    each batch Hamming-coded, QAM64 with guard bands, frames back to back
    through the channel at SNR 45 from a generator seeded with (seed, 4, i),
    zero-padded to bench.py's stream length (bench.py:268-283)."""
    _, _, flen = hamming_geometry()
    need = n_frames * flen + CFG.sym_len
    datas = hamming_payloads(seed, n_frames)
    streams = []
    for i, d in enumerate(datas):
        tx = encode_hamming(d, guard_bands=True, modulation=MOD, device=dev)
        s = channel(tx.reshape(-1), snr=SNR, generator=generator(dev, seed, 4, i))
        streams.append(torch.nn.functional.pad(s, (0, need - s.shape[0])))
    return datas, streams


def hamming_step(stream: torch.Tensor, n_frames: int):
    """Config 4's step: the public presync ``decode_regular`` with the
    Hamming decode on the stream's device; numpy (user bytes, ok)."""
    plen, _, flen = hamming_geometry()
    return decode_regular(stream, n_frames=n_frames, spacing=flen,
                          payload_len=plen, guard_bands=True, modulation=MOD,
                          fec="hamming", data_len=HAM_DATA_BYTES, resync=False)


# --- the configurations -------------------------------------------------------

def bench_headline(args, dev: torch.device) -> dict:
    reset_peak_memory(dev)
    datas, rxs, nb = headline_workload(args.seed, args.batch, args.payload, dev)
    planes = [torch.stack([x.real, x.imag], dim=1).contiguous() for x in rxs]
    kw = dict(n_blocks=nb, guard_bands=True, modulation=MOD)
    n_samples = rxs[0].numel()
    forms = {}
    for name, fn, inputs in (("complex", decode_frame, rxs),
                             ("planar", decode_frame_planar, planes)):
        out = fn(inputs[0], **kw)[:, HEADER_LEN:HEADER_LEN + args.payload]
        errs = int((out.cpu().numpy() != datas[0]).sum())
        gate(errs == 0, f"headline {name}: {errs} payload byte errors on the "
             "clean batch")
        t = timed(lambda i, fn=fn, inputs=inputs: fn(inputs[i % N_INPUTS], **kw),
                  args.steps, dev)
        prof = profiled(lambda fn=fn, inputs=inputs: fn(inputs[0], **kw), dev)
        median = t["ms_per_step"]["median_ms"]
        forms[name] = {"byte_errors_clean_batch": errs, **t,
                       "samples_per_s": n_samples / median * 1e3, **prof,
                       "idle_share": idle_share(prof["device_busy_ms"], median)}
    latency = []
    for i in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        decode_frame(rxs[i % N_INPUTS], **kw).cpu()
        latency.append((time.perf_counter() - t0) * 1e3)
    c = forms["complex"]
    return {"value": c["samples_per_s"], "detail": {
        "batch": args.batch, "frame_samples": rxs[0].shape[1],
        "payload_bytes": args.payload, **c,
        "blocking_latency_ms": {**summary(latency),
                                "mean_ms": statistics.fmean(latency)},
        "peak_memory_bytes": peak_memory(dev), "planar_input": forms["planar"]}}


def bench_hamming(args, dev: torch.device) -> dict:
    reset_peak_memory(dev)
    n = args.ham_frames
    plen, _, flen = hamming_geometry()
    datas, streams = hamming_workload(args.seed, n, dev)
    planes = [torch.stack([s.real, s.imag]) for s in streams]
    forms = {}
    for name, inputs in (("complex", streams), ("planar", planes)):
        errs = 0
        for x, d in zip(inputs, datas):
            got, ok = hamming_step(x, n)
            errs += int((got != d).sum()) + int((~ok).sum())
        gate(errs == 0, f"config 4 {name}: {errs} user byte errors")
        t = timed(lambda i, inputs=inputs: hamming_step(inputs[i % HAM_STREAMS], n),
                  args.steps, dev)
        prof = profiled(lambda inputs=inputs: hamming_step(inputs[0], n), dev)
        median = t["ms_per_step"]["median_ms"]
        forms[name] = {"user_byte_errors": errs, **t,
                       "samples_per_s": n * flen / median * 1e3,
                       "user_GBps": n * HAM_DATA_BYTES / median / 1e6, **prof,
                       "idle_share": idle_share(prof["device_busy_ms"], median)}
    c = forms["complex"]
    return {"metric": "samples/s (64QAM hamming streaming presync)",
            "value": c["samples_per_s"], "unit": "samples/s",
            "detail": {"n_frames": n, "frame_samples": flen,
                       "data_bytes": HAM_DATA_BYTES, "wire_bytes": plen,
                       "stream_samples": streams[0].shape[0], **c,
                       "peak_memory_bytes": peak_memory(dev),
                       "planar_input": forms["planar"]}}


def bench_serving(args, dev: torch.device, native_flags: list[str]) -> dict:
    reset_peak_memory(dev)
    n_frames, distinct = args.srv_frames, args.srv_distinct
    n_buf = distinct * args.srv_rounds
    t_buf = serving.buffer_len(n_frames)
    bufs, pixels = serving.synth_buffers(distinct, n_frames,
                                         seed_offset=args.seed, device=dev)
    coded = [serving.encode_rows(p) for p in pixels]
    planes = [torch.stack([b.real, b.imag]) for b in bufs]

    def errors(b: int, raw: np.ndarray, got: np.ndarray,
               ok: np.ndarray) -> np.ndarray:
        """(payload byte errors, images that differ, frames RS failed on)."""
        return np.array([int((raw != coded[b]).sum()),
                         int((got != pixels[b]).any(axis=1).sum()),
                         int((~ok).sum())])

    def failed(mode: str, bad: np.ndarray) -> str:
        return (f"serving {mode}: {bad[0]} payload byte errors, {bad[1]} "
                f"images differ, RS failed on {bad[2]} frames")

    def served(inputs, mode: str) -> dict:
        """``serve`` over n_buf buffers (after a checked warm-up pass over
        the distinct ones); host clock over all of them."""
        for sv in serving.serve(inputs, n_frames, in_flight=SRV_IN_FLIGHT):
            bad = errors(sv.index, sv.raw, sv.pixels, sv.ok)
            gate(not bad.any(), failed(f"{mode} warm-up buffer {sv.index}", bad))
        bad, lat, rs_ms, col_ms = np.zeros(3, int), [], [], []
        reset_launches()
        t0 = time.perf_counter()
        for sv in serving.serve((inputs[i % distinct] for i in range(n_buf)),
                                n_frames, in_flight=SRV_IN_FLIGHT):
            bad += errors(sv.index % distinct, sv.raw, sv.pixels, sv.ok)
            lat.append(sv.latency_s * 1e3)
            rs_ms.append(sv.rs_s * 1e3)
            col_ms.append(sv.colors_s * 1e3)
        ms = (time.perf_counter() - t0) * 1e3 / n_buf
        gate(len(lat) == n_buf, f"serving {mode}: {len(lat)} of {n_buf} "
             "buffers served")
        gate(not bad.any(), failed(mode, bad))
        return {"payload_byte_errors": int(bad[0]), "image_errors": int(bad[1]),
                "rs_failures": int(bad[2]), "ms_per_buffer": ms,
                "samples_per_s": t_buf / ms * 1e3,
                "image_frames_per_s": n_frames / ms * 1e3,
                "latency_ms": summary(lat),
                "rs_ms": statistics.median(rs_ms),
                "colorspace_ms": statistics.median(col_ms),
                "launches": launches_per(n_buf)}

    modes = {"d2h": served(bufs, "d2h")}
    kept = []

    def step(i: int) -> None:
        kept.append((i % distinct, serving.serve_step(bufs[i % distinct],
                                                      n_frames)))

    t = timed(step, n_buf, dev)
    bad = np.zeros(3, int)
    for b, out in kept:
        raw = out.cpu().numpy()
        got, _, ok, _, _ = serving.host_tail(raw)
        bad += errors(b, raw, got, ok)
    gate(not bad.any(), failed("device_resident", bad))
    ms = t["ms_per_step"]["wall_ms"]
    modes["device_resident"] = {
        "payload_byte_errors": int(bad[0]), "image_errors": int(bad[1]),
        "rs_failures": int(bad[2]), "ms_per_buffer": ms,
        **t, "samples_per_s": t_buf / ms * 1e3,
        "image_frames_per_s": n_frames / ms * 1e3}
    modes["planar"] = served(planes, "planar")

    # the parts alone: one payload slice's fetch, the host tail
    done = serving.serve_step(bufs[0], n_frames)
    raw = fetch_async(done).result()
    fetch_ms = median_s(lambda: fetch_async(done).result()) * 1e3
    ids, _ = rs.decode_payload_rows(raw, serving.USER_BYTES)
    prof = profiled(lambda: serving.serve_step(bufs[1], n_frames), dev)
    for m in modes.values():
        m["idle_share"] = idle_share(prof["device_busy_ms"], m["ms_per_buffer"])
    return {"metric": "sustained samples/s (serving: decode + RS + colorspace)",
            "value": modes["d2h"]["samples_per_s"], "unit": "samples/s",
            "detail": {"frames_per_buffer": n_frames, "samples_per_buffer": t_buf,
                       "buffers": n_buf, "distinct_buffers": distinct,
                       "in_flight": SRV_IN_FLIGHT, "rs_native": rs._LIB is not None,
                       "rs_codec": {
                           "openmp": native.uses_openmp("rs_codec"),
                           "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
                           "cpu_count": os.cpu_count(),
                           "built_now_with": native_flags or None},
                       **modes, "fetch_ms": fetch_ms, "payload_slice_bytes": raw.nbytes,
                       "rs_ms": median_s(lambda: rs.decode_payload_rows(
                           raw, serving.USER_BYTES)) * 1e3,
                       "colorspace_ms": median_s(lambda: id_to_rgb(
                           ids.reshape(-1))) * 1e3,
                       **prof, "peak_memory_bytes": peak_memory(dev)}}


# --- the command --------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ofdm_tpu_torch.bench",
        description="bench.py's configs 2, 4 and 5 on the port, byte-gated; "
                    "prints one JSON line")
    p.add_argument("--seed", type=int, default=0,
                   help="workload seed (0 draws bench.py's payloads)")
    p.add_argument("--only", choices=("headline",),
                   help="run the headline (config 2) alone")
    add_device_arg(p)
    for flag, default, what in (
            ("--batch", BATCH, "headline frames per step"),
            ("--payload", PAYLOAD, "headline payload bytes"),
            ("--ham-frames", HAM_FRAMES, "config 4 frames per stream"),
            ("--srv-frames", SRV_FRAMES, "config 5 frames per buffer"),
            ("--srv-distinct", SRV_DISTINCT, "config 5 distinct buffers"),
            ("--srv-rounds", SRV_ROUNDS, "config 5 rounds over them"),
            ("--steps", STEPS, "timed steps of the headline and config 4")):
        p.add_argument(flag, type=int, default=default, help=f"{what} ({default})")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    build_s = None
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
    configs = {}
    if args.only is None:
        # serving's RS codec, or raise; flags only where it was compiled now
        native_flags = native.build(("rs_codec",))[1]
    head = bench_headline(args, dev)
    if args.only is None:
        configs["hamming_streaming"] = bench_hamming(args, dev)
        configs["serving"] = bench_serving(args, dev, native_flags)
    print(json.dumps({
        "metric": "samples/s (64QAM rx chain)", "value": head["value"],
        "unit": "samples/s", "seed": args.seed, "device": device_info(dev),
        "detail": {**head["detail"], "kernel_build_s": build_s,
                   "configs": configs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
