#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ofdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ofdm_tpu_torch/csrc/ and runs five phases:

  1. device: card name and power limit, TF32 flags, kernel build time;
  2. sync_align against its plain PyTorch version: headline shape with
     complex and planar input, one ~1M-sample row, a search window, a
     complex template.  Windows and offsets must be identical;
  3. eq_demod_pack against its plain version: headline shape QAM64 with a
     CFO phase, QPSK, BPSK without guard bands.  Bytes must be identical;
  4. end to end on the card: 256 x 8,192-byte payloads, encode (QAM64,
     guard bands), channel at SNR 45 without and with CFO, decode_frame on
     both.  The clean batch must decode with 0 byte errors, >= 95% of the
     CFO rows exactly, and the two calls must have launched each kernel
     exactly twice.  Then decode_frame_planar must give the same bytes and
     decode the payload (each one launch of each kernel), and on both
     batches both kernels must equal their plain versions;
  5. timing: decode_frame per step with CUDA events and its device busy time
     from torch.profiler; each kernel's device time per call (profiler)
     beside its plain version's.  The ``kernels`` line carries these.

Any failed check raises and the script exits non-zero without the final
line.  The last three lines are the card's ``nvidia-smi`` name and power
limit, one JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import ofdm_tpu_torch as ott  # noqa: E402
from ofdm_tpu_torch import constants  # noqa: E402
from ofdm_tpu_torch.kernels import _build  # noqa: E402
from ofdm_tpu_torch.kernels.align import sync_align, sync_align_reference  # noqa: E402
from ofdm_tpu_torch.kernels.demod import eq_demod_pack, eq_demod_pack_reference  # noqa: E402
from ofdm_tpu_torch.phy import rx as rx_mod  # noqa: E402
from ofdm_tpu_torch.phy.modulation import (BITS_PER_SYMBOL,  # noqa: E402
                                            modulate_bytes_packed)

BATCH = 256
PAYLOAD = 8192
MOD = ott.Modulation.QAM64
SNR = 45.0
REPS = 30
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, sessions: int = 15) -> dict:
    """Device time of each kernel one call of ``fn`` runs, from torch.profiler
    (CUPTI): one call per profiler session, and the session whose total is
    the median.  (Sessions of many calls were seen to lose events.)  Fails if
    the profiler saw no device activity."""
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
    check(sum(median.values()) > 0, "torch.profiler saw no device time")
    return median


def counted(fn):
    """Run ``fn`` with both kernels' launch counters set to 0; return its
    result and the counts it left."""
    torch.cuda.synchronize()
    sync_align.launches = 0
    eq_demod_pack.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"sync_align": sync_align.launches,
                 "eq_demod_pack": eq_demod_pack.launches}


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the rows of [R, T] to at least n samples."""
    return torch.cat([x, x.new_zeros((x.shape[0], max(0, n - x.shape[1])))], 1)


def synth_sync(gen, dev, rows, t, delays, template, scale=1.0):
    """Noise at 0.01 with the template added at the given per-row delays."""
    s = 0.01 * torch.complex(
        torch.randn((rows, t), generator=gen, device=dev),
        torch.randn((rows, t), generator=gen, device=dev))
    tpl = torch.as_tensor(template, dtype=torch.complex64, device=dev)
    for i, d in enumerate(delays):
        s[i, d:d + tpl.shape[0]] += scale * tpl
    return s


def phase_sync_align(gen, dev, template):
    """K1 against its plain version; returns the largest window difference."""
    need = (10 + 228) * 80
    cases = []
    t = 19183
    delays = torch.randint(0, 200, (BATCH,), generator=gen, device=dev).tolist()
    s = synth_sync(gen, dev, BATCH, t, delays, template)
    planes = torch.stack([s.real, s.imag], dim=1).contiguous()
    cases += [("headline complex in", s, template, need, None, delays),
              ("headline planar in", planes, template, need, None, delays)]
    t_long = 1_000_003
    long_delays = [654_321, 987_000]          # the second lies past T - need
    cases.append(("long row", synth_sync(gen, dev, 2, t_long, long_delays,
                                         template), template, need, None,
                  long_delays))
    sw = synth_sync(gen, dev, BATCH, t, delays, template)
    sw[:, 5000:5000 + len(template)] += 2.0 * torch.as_tensor(
        template, dtype=torch.complex64, device=dev)   # a louder decoy outside the window
    cases.append(("search_window=256", sw, template, need, 256, delays))
    tpl_c = (template * complex(0.7648, 0.6442)).astype(template.dtype)
    cd = delays[:16]
    cases.append(("complex template", synth_sync(gen, dev, len(cd), 2560, cd, tpl_c),
                  tpl_c, 2400, None, cd))
    worst = 0.0
    for name, x, tpl, nd, win, dl in cases:
        t_x = x.shape[-1]
        want_raw = torch.as_tensor(dl, device=dev, dtype=torch.int32) - 1
        for planar in (False, True):
            got, raw = sync_align(x, tpl, nd, search_window=win, planar=planar)
            ref, raw_ref = sync_align_reference(x, tpl, nd, search_window=win,
                                                planar=planar)
            torch.cuda.synchronize()
            check(torch.equal(raw, raw_ref), f"sync_align {name}: offsets differ")
            check(torch.equal(raw, want_raw), f"sync_align {name}: wrong peak")
            diff = (got - ref).abs().max().item()
            worst = max(worst, diff)
            check(diff == 0.0, f"sync_align {name} planar={planar}: window "
                  f"differs by {diff}")
        print(f"phase 2 sync_align {name}: rows={x.shape[0]} T={t_x} need={nd} "
              f"windows and offsets identical")
    return worst


def synth_tail(gen, dev, mod, guard_bands):
    """Tail inputs with a known answer: symbols through a random channel, a
    per-chunk CFO rotation, a pilot phase and noise at SNR 45."""
    cfg = ott.DEFAULT_CONFIG
    sel, nd, n_pilots = rx_mod._selected_bins(guard_bands, cfg)
    nb = ott.n_data_blocks(PAYLOAD, mod, guard_bands)
    bpb = nd * BITS_PER_SYMBOL[mod] // 8
    sent = torch.randint(0, 256, (BATCH, nb * bpb), generator=gen, device=dev,
                         dtype=torch.uint8)
    x = modulate_bytes_packed(sent, mod).reshape(BATCH, nb, nd)
    if n_pilots:
        x = torch.cat([x, torch.ones((BATCH, nb, n_pilots), dtype=x.dtype,
                                     device=dev)], dim=-1)
    nbins = len(sel)
    h = torch.polar(0.5 + torch.rand((BATCH, nbins), generator=gen, device=dev),
                    6.3 * torch.rand((BATCH, nbins), generator=gen, device=dev))
    f_delta = 3.14159 / 80 * torch.rand(BATCH, generator=gen, device=dev)
    chunk = torch.arange(nb, device=dev, dtype=torch.float32) + cfg.n_sync_chunks
    rot = torch.polar(torch.ones(BATCH, nb, device=dev),
                      f_delta[:, None] * chunk * cfg.sym_len)
    phi = torch.polar(torch.ones(BATCH, nb, 1, device=dev),
                      0.05 * torch.randn((BATCH, nb, 1), generator=gen, device=dev))
    y = x * h[:, None, :] * rot[..., None] * phi
    p = (y.abs() ** 2).mean()
    amp = torch.sqrt(p / 10 ** (SNR / 10) / 2)
    y = y + amp * torch.complex(
        torch.randn(y.shape, generator=gen, device=dev),
        torch.randn(y.shape, generator=gen, device=dev))
    out = torch.cat([y.real, y.imag], dim=-1).contiguous()   # the DFT's layout
    return (out[..., :nbins], out[..., nbins:], h.to(torch.complex64), f_delta,
            nd, n_pilots, sent)


def phase_eq_demod(gen, dev):
    worst = 0
    for mod, gb in [(ott.Modulation.QAM64, True), (ott.Modulation.QPSK, True),
                    (ott.Modulation.BPSK, False)]:
        yr, yi, h, fd, nd, npil, sent = synth_tail(gen, dev, mod, gb)
        kw = dict(n_data=nd, n_pilots=npil, modulation=mod, cfg=ott.DEFAULT_CONFIG)
        got = eq_demod_pack(yr, yi, h, fd, **kw)
        ref = eq_demod_pack_reference(yr, yi, h, fd, **kw)
        torch.cuda.synchronize()
        diff = (got.int() - ref.int()).abs().max().item()
        worst = max(worst, diff)
        check(diff == 0, f"eq_demod_pack {mod.value}: bytes differ from plain")
        check(torch.equal(got, sent), f"eq_demod_pack {mod.value}: decode errors")
        print(f"phase 3 eq_demod_pack {mod.value} guard_bands={gb}: "
              f"B={yr.shape[0]} NB={yr.shape[1]} nbins={yr.shape[2]} "
              "bytes identical, payload exact")
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    print(f"phase 1 device: {name_limit}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = [_build.build("sync_align"), _build.build("eq_demod_pack")]
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.2f} s into {_build.BUILD_DIR}")
    for so in libs:
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {so.name}: {line.strip()}")

    gen = torch.Generator(dev).manual_seed(SEED)
    template = constants.locking_for(ott.DEFAULT_CONFIG)
    k1_err = phase_sync_align(gen, dev, template)
    k2_err = phase_eq_demod(gen, dev)

    # phase 4: the port alone, end to end on the card
    nb = ott.n_data_blocks(PAYLOAD, MOD, True)
    data = torch.randint(0, 256, (BATCH, PAYLOAD), generator=gen, device=dev,
                         dtype=torch.uint8)
    tx = ott.encode(data, guard_bands=True, modulation=MOD)
    # rows padded to bench.py's headline frame: sync prefix + one spare
    # symbol + the data blocks (T = 19,120 samples)
    frame = ott.DEFAULT_CONFIG.sync_len + 80 + nb * 80
    rx_clean, rx_cfo = (
        pad_rows(ott.channel(tx, snr=SNR, timing_error=cfo, generator=gen), frame)
        for cfo in (False, True))
    planes_in = torch.stack([rx_clean.real, rx_clean.imag], dim=1).contiguous()
    kw = dict(n_blocks=nb, guard_bands=True, modulation=MOD)
    # the main path alone between zeroing and reading the counters
    (out_clean, out_cfo), launches = counted(
        lambda: (ott.decode_frame(rx_clean, **kw), ott.decode_frame(rx_cfo, **kw)))
    check(launches == {"sync_align": 2, "eq_demod_pack": 2},
          f"decode_frame x2 launched {launches}, want 2 of each kernel")
    check(tuple(out_clean.shape) == (BATCH, nb * 36),
          f"decode_frame shape {tuple(out_clean.shape)}")
    errs = int((out_clean[:, 16:16 + PAYLOAD] != data).sum())
    check(errs == 0, f"clean batch: {errs} payload byte errors")
    good = int((out_cfo[:, 16:16 + PAYLOAD] == data).all(dim=1).sum())
    check(good >= 0.95 * BATCH, f"CFO batch: only {good}/{BATCH} rows exact")
    print(f"phase 4 end to end: decode_frame on {BATCH} x {PAYLOAD} B QAM64 "
          f"SNR {SNR}, T={frame}: clean byte errors 0; CFO rows exact "
          f"{good}/{BATCH}; launches {launches}")

    out_planar, n_planar = counted(lambda: ott.decode_frame_planar(planes_in, **kw))
    check(n_planar == {"sync_align": 1, "eq_demod_pack": 1},
          f"decode_frame_planar launched {n_planar}")
    check(torch.equal(out_planar, out_clean), "decode_frame_planar differs")
    payload0, n_decode = counted(
        lambda: ott.decode(rx_clean[0], guard_bands=True, modulation=MOD))
    check(n_decode == {"sync_align": 1, "eq_demod_pack": 1},
          f"decode launched {n_decode}")
    check(payload0.shape == (PAYLOAD,)
          and bool((torch.as_tensor(payload0, device=dev) == data[0]).all()),
          "decode: payload differs")
    print(f"phase 4 decode_frame_planar: bytes equal decode_frame's, launches "
          f"{n_planar}; decode: payload exact, launches {n_decode}")

    # K1 and K2 against their plain versions at the main path's own shapes
    need = (ott.DEFAULT_CONFIG.n_sync_chunks + nb) * 80
    tail_kw = dict(n_data=48, n_pilots=4, modulation=MOD, cfg=ott.DEFAULT_CONFIG)
    for name, x in (("clean", rx_clean), ("CFO", rx_cfo)):
        planes, raw = sync_align(x, template, need, planar=True)
        planes_ref, raw_ref = sync_align_reference(x, template, need, planar=True)
        check(torch.equal(raw, raw_ref), f"{name} batch: sync offsets differ "
              f"from plain on {int((raw != raw_ref).sum())} rows")
        diff = (planes - planes_ref).abs().max().item()
        k1_err = max(k1_err, diff)
        check(diff == 0.0, f"{name} batch: sync_align window differs by {diff}")
        cp = planes.reshape(BATCH, 2, -1, 80)
        ti = rx_mod._tail_inputs(cp[:, 0], cp[:, 1], guard_bands=True,
                                 cfg=ott.DEFAULT_CONFIG, cfo_estimator="coherent")
        k2 = eq_demod_pack(*ti, **tail_kw)
        k2_ref = eq_demod_pack_reference(*ti, **tail_kw)
        k2_err = max(k2_err, (k2.int() - k2_ref.int()).abs().max().item())
        check(torch.equal(k2, k2_ref), f"{name} batch: eq_demod_pack differs "
              "from plain")
        print(f"phase 4 {name} batch at R={BATCH} T={x.shape[1]}: sync_align "
              "offsets and planes, eq_demod_pack bytes identical to plain")

    # phase 5: timing
    step_ms = time_ms(lambda: ott.decode_frame(rx_clean, **kw))
    n_samples = rx_clean.shape[0] * rx_clean.shape[1]
    step_kernels = device_ms(lambda: ott.decode_frame(rx_clean, **kw))
    busy = sum(step_kernels.values())
    print(f"phase 5 timing on {name_limit}: decode_frame {BATCH}x"
          f"{rx_clean.shape[1]} QAM64 {step_ms:.4f} ms/step, "
          f"{n_samples / step_ms * 1e3:.4e} samples/s (CUDA events, median of "
          f"{REPS}); device busy {busy:.4f} ms/step (torch.profiler), idle share "
          f"{1 - busy / step_ms:.3f}, {len(step_kernels)} kernel names; build "
          f"{build_s:.2f} s")
    for kname, ms in sorted(step_kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:.4f} ms/step  {kname[:110]}")
    # per kernel: device time per call from the profiler, plain version
    # beside; K1 on the clean rows, K2 on the CFO batch's tail inputs
    dev_ms = {}
    for label, fn in [
            ("sync_align", lambda: sync_align(rx_clean, template, need, planar=True)),
            ("sync_align plain", lambda: sync_align_reference(rx_clean, template,
                                                              need, planar=True)),
            ("eq_demod_pack", lambda: eq_demod_pack(*ti, **tail_kw)),
            ("eq_demod_pack plain", lambda: eq_demod_pack_reference(*ti, **tail_kw))]:
        dk = device_ms(fn)
        dev_ms[label] = sum(dk.values())
        print(f"phase 5 device time {label}: {dev_ms[label]:.4f} ms/call "
              f"in {len(dk)} kernel names on {name_limit}")

    kernels = [
        {"name": "sync_align", "route": "cuda",
         "source": "ofdm_tpu_torch/csrc/sync_align.cu",
         "replaces": "ofdm_tpu/kernels/align_pallas.py:126",
         "launches": launches["sync_align"], "max_abs_err": k1_err,
         "ms": dev_ms["sync_align"], "plain_ms": dev_ms["sync_align plain"]},
        {"name": "eq_demod_pack", "route": "cuda",
         "source": "ofdm_tpu_torch/csrc/eq_demod_pack.cu",
         "replaces": "ofdm_tpu/kernels/demod_pallas.py:166",
         "launches": launches["eq_demod_pack"], "max_abs_err": k2_err,
         "ms": dev_ms["eq_demod_pack"],
         "plain_ms": dev_ms["eq_demod_pack plain"]},
    ]
    print(name_limit)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
