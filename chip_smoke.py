#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ofdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the host code under native/ (the RS codec and the IQ loader,
``ofdm_tpu_torch.core.native.build``, which reloads the port's modules that
load them), then the CUDA kernels from ofdm_tpu_torch/csrc/ (one nvcc per
source, all at once), and runs sixteen phases:

  1. device: card name and power limit, TF32 flags, kernel build time;
  2. sync_align (K1) against its plain PyTorch version: headline shape with
     complex and planar input, one ~1M-sample row, a search window, a
     complex template, and the correlation pass's edges: 1 and 128 taps
     (real and complex), a scan that ends 3 lags into a block, a row
     shorter than one block, exact ties between a scan's first and last
     lags.  Windows and offsets must be identical;
  3. eq_demod_pack (K2) against its plain version: headline shape QAM64 with
     a CFO phase, QPSK, BPSK without guard bands, QAM16 and QAM256, each
     also through a block table (the chunked route's slot order), and
     QAM64 with guard bands but no pilots.  Bytes must be identical;
  4. end to end on the card: 256 x 8,192-byte payloads, encode (QAM64,
     guard bands), channel at SNR 45 without and with CFO, decode_frame on
     both.  The clean batch must decode with 0 byte errors, >= 95% of the
     CFO rows exactly, and the two calls must have launched K1 and K2
     exactly twice each and no other kernel.  Then decode_frame_planar must
     give the same bytes and decode the payload (one launch each of K1 and
     K2), and on both batches K1 and K2 must equal their plain versions;
  5. timing: decode_frame per step with CUDA events and its device busy time
     from torch.profiler; K1's and K2's device time per call (profiler)
     beside their plain versions';
  6. planar_align (K3), sync_align_chunked (K4) and pin_rowmajor (K5)
     against their plain versions at the headline shape (R = 256,
     T = 19,120): K3 with offsets that include 0 and T - need, K4 on complex
     and planar input (every lane of every slot), K5 on the planes of the
     complex capture, view_as_real(rx).transpose(1, 2).  Each torch.equal;
  7. end to end on the other routes, each with the phase-4 gates and exact
     launch counts: decode_frame with sync_dtype=bfloat16 (K3 + K2; the
     clean batch also with "fft" and "conv"),
     align_impl="chunked" (K4 + K2) and decode_frame_planar chunked,
     decode_frame_planar on the strided view (K5 + K1 + K2), and the
     160-tap-template geometry (n_fft 128, cp 32, 3 training, 2 preamble
     chunks) through decode_frame (K3 + K2) and decode on one row;
  8. timing: decode_frame ms/step per route (CUDA events) and its device
     busy time, and the device time per call of K3, K4 and K5 beside their
     plain versions' and beside the one PyTorch call that computes the same
     function (K3: one advanced-indexing gather; K5: ``x.contiguous()``).
     The ``kernels`` line carries phases 5 and 8 and each kernel's bound:
     the larger of its flops at the fp32 peak and its bytes at the memory
     rate, from this run's shapes;
  9. stream decoding at bench.py's config 4: 256 Hamming(7,4) frames of
     4,680 user bytes (QAM64, guard bands, 19,040 samples each) back to
     back in one 4,874,320-sample stream, made on the card (encode_hamming,
     channel at SNR 45).  decode_regular presync and resync, on the complex
     stream and on the planar [2, T] stream with all three presync
     handoffs: 0 byte errors, the same bytes on every route, exact launch
     counts (presync K3 1 + K2 1, resync K3 1 + K1 1 + K2 1) and one
     synchronizing call per decode (the output fetch, by
     torch.cuda.set_sync_debug_mode).  Then the short-buffer stream of
     fault F1 (first frame at 523, spacing 19,240, cut at the last frame's
     end as received): 0 byte errors presync and resync.  K3's shared-stream mode is
     held against its plain version in phase 6;
 10. decode_burst on 64 such frames at random gaps of 300-2,200 samples
     (SNR 25, with CFO): every frame found within 2 samples of its start,
     0 byte errors, launches K3 1 + K2 1; decode_continuous on its first 8
     frames: the same positions and bytes, K1 8 + K2 8;
 11. timing of decode_regular (CUDA events, median of 30 steps, each
     ending in its output fetch) presync and resync on both stream forms,
     its device busy time, idle share and top device items; the device
     launches per step and the eager Hamming decode's share of them; and
     K3's shared-stream cut beside its plain version and its bound;
 12. serving at bench.py's config 5 (tools/exp_serving.py): 8 distinct
     buffers of 780 RS-coded 24 x 24 id images (QAM64, guard bands, 2,560
     samples a frame, 1,996,960 samples a buffer, SNR 45, odd buffers with
     CFO), made on the card, served 6 rounds (48 buffers) with 4 in flight
     in three modes: feed (a capture thread, pinned double-buffered
     uploads), device-resident, and planar capture (fc32 files read back
     through Capture and uploaded as planes).  Every image of every buffer
     must equal its transmitted pixels; each serve step launches K3 1 + K1
     1 + K2 1 and makes no synchronizing call before its fetch; K1 and K3
     at the serving shape equal their plain versions; the native RS codec
     and IQ loader are loaded; rx_stream runs on the card.  Then the
     timing: per mode ms/buffer, samples/s, image frames/s, p50 and p99
     latency; H2D through the pinned ring and pageable; the payload fetch;
     the host tail (RS, colorspace); the step's device busy time and idle
     share; K3 and K1 at the serving shape beside their plain versions and
     bounds; the serial sum of the parts against feed mode;
 13. frozen captures and diagnostics: the three captures under tests/golden/
     that the JAX package wrote and decoded (QAM64 1 row, QAM256 4 rows of
     8,192-byte payloads at SNR 55, BPSK 4 rows at SNR 20 with CFO), read
     with the port's read_iq and decoded by decode_frame on the card as
     stored and tiled to 256 rows: the bytes must equal the JAX package's
     on every row (torch.equal), launches K1 1 + K2 1 per call.  Row 0 of
     each through decode(return_diagnostics=True): the payload JAX's decode
     gave, the offset decode_frame's sync finds, the CPU's keys, shapes and
     (to 1e-4) signals, and K1 1 + K2 1 with and without the diagnostics.
     The full-fp32 guard in subprocesses on the card under each way of
     setting PyTorch's TF32 flags, one of which decodes a capture with TF32
     turned off through fp32_precision alone;
 14. the apps on the card, each through its main([... "--device", "cuda"]):
     ber_sweep.measure_ber at 256 x 8,192-byte payloads with guard bands
     for all five modulations at their operating SNR (45; QAM256 55: BER
     exactly 0) and at SNR 5 (BER > 0), K1 1 + K2 1 per point, its time
     per point; ber_sweep --awgn-theory within 20% of the analytic curve;
     lab3a with taps, lab3b, lab3c, monitor, lab3b_image, lab3c_image,
     stream_bytes and transmitloop into rx_stream --files, datatoframe,
     probe; then the timing of
     decode_frame and encode per step at 256 x 8,192 B for each modulation
     (CUDA events, median of 30), every batch byte-gated in the same run;
     profiler.trace around two decode_frame steps (the chrome trace names
     K1's and K2's kernels), timed and annotate.
 15. parallel/ on a world-size-1 NCCL group and a (1, 1) mesh on cuda:0 (the
     card host has one card, and NCCL takes one rank per card), at full
     width: decode_frame_sharded on the clean and CFO headline batches (K1
     1 + K2 1 each), decode_frame_planar_sharded on contiguous planes (K1 +
     K2), on the strided view (K5 + K1 + K2) and chunked (K4 + K2), each
     byte-equal to decode_frame; decode_frame_timesharded on both batches
     (sync_keys 1 + K3 1 each), byte-equal on the clean batch and on the
     CFO rows both decode exactly; sync_keys against its plain version at
     the headline's haloed shard (lags equal, power within 1e-6 relative);
     the time-sharded channel without noise within 1e-5 of np.convolve in
     float64 on the host; decode_regular_sharded at config 4 (K3 1 + K1 1 + K2 1,
     decode_regular's bytes, one synchronizing call); decode_burst_sharded
     on phase 10's frames (decode_burst's); make_pipeline_step at 256 x
     8,192 B QAM64, SNR 45, timing error: 0 bit errors, sync_keys 1 + K3 1,
     no all_gather; the same step at the same width in a one-rank NCCL world
     of ``parallel.dist_worker`` (its default route, started by
     tests/test_torch_world.py's ``World``): 0 bit errors, sync_keys 1 + K3
     1 a step.  Each sharded call beside its single-device counterpart in
     ms/step and device busy.  Then the pipeline step in 1- and 2-process
     gloo worlds on the host's CPU: 0 bit errors and the wall time per
     step, labelled "CPU, gloo" (a check of the mechanism, not a scaling
     point);
 16. the port's bench as its users run it.  First K3, K1 and K2 against
     their plain versions on the inputs that the serve step hands each of
     them on the bench's own serving buffers (4 of 390 frames, seed 0),
     complex and planar (torch.equal), every payload row the RS code bytes
     that were sent.  Then ``python -m ofdm_tpu_torch.bench --seed 0`` in a
     subprocess (bench.py's configs 2, 4 and 5 at full size), then ``--seed
     1 --only headline``.  Each must exit 0 with every
     gate of its line at 0, this card's nvidia-smi name and power limit,
     100 timed steps (buffers) with a p90, and the launches per step: K1 1 +
     K2 1 per headline step (complex and planar), K3 1 + K2 1 per config-4
     step, K3 1 + K1 1 + K2 1 per serve step in every mode.  Its numbers
     are printed beside phases 5 and 11's synchronized times of the same
     steps, and its line whole.

Any failed check raises and the script exits non-zero without the final
line.  The last three lines are the card's ``nvidia-smi`` name and power
limit, one JSON object describing each kernel (the five and ``sync_keys``,
K1's correlation pass as the time-sharded sync), and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


if __name__ == "__main__" and not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")

import ofdm_tpu_torch as ott  # noqa: E402
from ofdm_tpu_torch import constants  # noqa: E402
from ofdm_tpu_torch.apps import (ber_sweep, datatoframe, lab3a, lab3b,  # noqa: E402
                                 lab3b_image, lab3c, lab3c_image, monitor,
                                 probe, rx_stream, stream_bytes, transmitloop)
from ofdm_tpu_torch.apps.common import seeded_image  # noqa: E402
from ofdm_tpu_torch.bench import (KERNELS, SRV_DISTINCT as BENCH_SRV_DISTINCT,  # noqa: E402
                                  SRV_FRAMES as BENCH_SRV_FRAMES, card,
                                  device_ms, median_s, reset_launches)
from ofdm_tpu_torch.core import native  # noqa: E402
from ofdm_tpu_torch.core.transfer import (Uploader, fetch_async,  # noqa: E402
                                          to_device_planar)
from ofdm_tpu_torch.fec import hamming  # noqa: E402
from ofdm_tpu_torch.fec import reed_solomon as rs  # noqa: E402
from ofdm_tpu_torch.io import capture as capture_mod  # noqa: E402
from ofdm_tpu_torch.io import iqfile, serving  # noqa: E402
from ofdm_tpu_torch.io.feed import SampleFeed, double_buffered  # noqa: E402
from ofdm_tpu_torch.kernels import _build  # noqa: E402
from ofdm_tpu_torch.kernels.align import (key_lag, key_power,  # noqa: E402
                                          pin_rowmajor, pin_rowmajor_reference,
                                          planar_align, planar_align_reference,
                                          sync_align, sync_align_reference,
                                          sync_keys, sync_keys_reference)
from ofdm_tpu_torch.kernels.chain import (sync_align_chunked,  # noqa: E402
                                          sync_align_chunked_reference)
from ofdm_tpu_torch.kernels.demod import eq_demod_pack, eq_demod_pack_reference  # noqa: E402
from ofdm_tpu_torch.obs import ber_theory, profiler  # noqa: E402
from ofdm_tpu_torch.obs.analysis import bit_errors  # noqa: E402
from ofdm_tpu_torch.obs.logging import set_up_logging  # noqa: E402
from ofdm_tpu_torch.ops.fft import set_full_fp32  # noqa: E402
from ofdm_tpu_torch.parallel import halo as halo_mod  # noqa: E402
from ofdm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from ofdm_tpu_torch.parallel.pipeline import (  # noqa: E402
    decode_burst_sharded, decode_frame_planar_sharded, decode_frame_sharded,
    decode_regular_sharded, make_pipeline_step)
from ofdm_tpu_torch.parallel.timeshard import (  # noqa: E402
    channel_timesharded_fn, decode_frame_timesharded)
from ofdm_tpu_torch.phy import rx as rx_mod  # noqa: E402
from ofdm_tpu_torch.packets.colors import id_to_rgb  # noqa: E402
from ofdm_tpu_torch.phy import streaming as streaming_mod  # noqa: E402
from ofdm_tpu_torch.phy.streaming import coded_len  # noqa: E402
from ofdm_tpu_torch.phy.modulation import (BITS_PER_SYMBOL,  # noqa: E402
                                            modulate_bytes_packed)
from tests import test_torch_world as world_mod  # noqa: E402  (the launcher)

BATCH = 256
PAYLOAD = 8192
MOD = ott.Modulation.QAM64
SNR = 45.0
REPS = 30
SEED = 0
# config 4 of bench.py: Hamming-coded stream decoding
HAM_FRAMES = 256
HAM_BYTES = 4680
BURST_FRAMES = 64
# config 5 of bench.py: serving (tools/exp_serving.py:55-58)
SRV_DISTINCT = 8
SRV_ROUNDS = 6
SRV_IN_FLIGHT = 4
# NVIDIA's H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"): the larger
    of flops at the fp32 peak and bytes at the memory rate."""
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call, the host
    waiting for each call's end before it issues the next (the bench's
    ``timed`` does not wait: phase 16 prints the two side by side)."""
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


LAUNCH_REPS = 100


def launch_ms(fn, reps: int = LAUNCH_REPS) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls (after a warm-up), over ``reps``.  For a call whose
    device work outlasts its host enqueue, the queue never drains, so
    this is its device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def counted(fn):
    """Run ``fn`` with every kernel's launch counter set to 0; return its
    result and the counts it left."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in KERNELS.items()}


def launches(**want) -> dict:
    """The exact count dict of a route: the named kernels, every other 0."""
    return {name: want.get(name, 0) for name in KERNELS}


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


def tie_rows(dev, tpl, t, lag_bound):
    """Rows whose peak power ties exactly between two lags: integer samples
    and an integer template, so every correlation sum is exact in any order.
    Row 0 holds the template at the first and the last lag of the scan,
    row 1 is all zeros (every lag ties), row 2 holds it at lag 5 and the
    last lag, row 3 at the last lag with a louder copy past the scan.
    Returns (rows, the lag each row must resolve to)."""
    k, last = len(tpl), lag_bound - 1
    w = torch.as_tensor(tpl, dtype=torch.complex64, device=dev)
    s = torch.zeros((4, t), dtype=torch.complex64, device=dev)
    for row, lag, scale in ((0, 0, 1), (0, last, 1), (2, 5, 1), (2, last, 1),
                            (3, last, 1), (3, t - k, 2)):
        s[row, lag:lag + k] += scale * w
    return s, [0, 0, 5, last]


def phase_sync_align(gen, dev, template):
    """K1 against its plain version; returns the largest window difference.
    Besides the headline shapes, the edges of the correlation pass (8 lags
    per thread, 1,024 per block): 1 and 128 taps, a scan that ends 3 lags
    into a block, a row shorter than one block, and exact ties between the
    first and the last lag of a scan."""
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

    rng = np.random.default_rng(SEED)
    tpl1 = np.ones(1, np.complex64)
    d1 = torch.randint(0, 4000, (64,), generator=gen, device=dev).tolist()
    cases.append(("K=1 tap", synth_sync(gen, dev, 64, 5000, d1, tpl1), tpl1,
                  1000, None, d1))
    for kind in ("real", "complex"):
        tpl128 = rng.standard_normal(128) + (1j * rng.standard_normal(128)
                                             if kind == "complex" else 0)
        tpl128 = (tpl128 / np.abs(tpl128).max()).astype(np.complex64)
        cases.append((f"K=128 {kind} template",
                      synth_sync(gen, dev, 64, 5000, d1, tpl128), tpl128, 1000,
                      None, d1))
    # lag_bound = 1,971 + 80 = 2,051: 3 lags into the third block, and not
    # a multiple of 8; peaks on both sides of the block edge and at the last lag
    de = [0, 7, 1023, 1024, 2047, 2048, 2049, 2050] + torch.randint(
        0, 2051, (56,), generator=gen, device=dev).tolist()
    cases.append(("lag_bound 2,051", synth_sync(gen, dev, 64, 5000, de, template),
                  template, 1000, 1971, de))
    ds = [0, 1, 99, 100, 620] + torch.randint(0, 621, (59,), generator=gen,
                                              device=dev).tolist()
    cases.append(("T=700, shorter than a block",
                  synth_sync(gen, dev, 64, 700, ds, template), template, 600,
                  None, ds))
    tpl_int = rng.choice([-2.0, -1.0, 1.0, 2.0], 80).astype(np.complex64)
    tpl_int_c = (tpl_int + 1j * rng.choice([-1.0, 1.0], 80)).astype(np.complex64)
    for kind, tpl_t in (("real", tpl_int), ("complex", tpl_int_c)):
        ties, first = tie_rows(dev, tpl_t, 5000, 2051)
        cases.append((f"exact ties, {kind} template", ties, tpl_t, 1000, 1971,
                      first))
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
              f"K={len(tpl)} search_window={win}: windows and offsets identical")
    return worst


def synth_tail(gen, dev, mod, guard_bands, snr=SNR):
    """Tail inputs with a known answer: symbols through a random channel, a
    per-chunk CFO rotation, a pilot phase and noise at ``snr``."""
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
    amp = torch.sqrt(p / 10 ** (snr / 10) / 2)
    y = y + amp * torch.complex(
        torch.randn(y.shape, generator=gen, device=dev),
        torch.randn(y.shape, generator=gen, device=dev))
    out = torch.cat([y.real, y.imag], dim=-1).contiguous()   # the DFT's layout
    return (out[..., :nbins], out[..., nbins:], h.to(torch.complex64), f_delta,
            nd, n_pilots, sent)


def phase_eq_demod(gen, dev):
    """K2 against its plain version on all five modulations, each also
    through a block table (the chunked route's slot order), and with guard
    bands but no pilots; returns the largest byte difference."""
    worst = 0

    def compare(label, args, kw):
        nonlocal worst
        got = eq_demod_pack(*args, **kw)
        ref = eq_demod_pack_reference(*args, **kw)
        torch.cuda.synchronize()
        diff = (got.int() - ref.int()).abs().max().item()
        worst = max(worst, diff)
        check(diff == 0, f"eq_demod_pack {label}: bytes differ from plain")
        return got

    for mod, gb in [(ott.Modulation.QAM64, True), (ott.Modulation.QPSK, True),
                    (ott.Modulation.BPSK, False), (ott.Modulation.QAM16, True),
                    (ott.Modulation.QAM256, True)]:
        # QAM256's corner points need SNR 55 to decode clean after the pilots'
        # phase noise (tests/test_torch_kernels.py::_tail_case)
        snr = 55.0 if mod is ott.Modulation.QAM256 else SNR
        yr, yi, h, fd, nd, npil, sent = synth_tail(gen, dev, mod, gb, snr)
        kw = dict(n_data=nd, n_pilots=npil, modulation=mod, cfg=ott.DEFAULT_CONFIG)
        got = compare(mod.value, (yr, yi, h, fd), kw)
        check(torch.equal(got, sent), f"eq_demod_pack {mod.value}: decode errors")
        # blocks read in reverse order
        blocks = torch.arange(yr.shape[1] - 1, -1, -1, dtype=torch.int32,
                              device=dev)
        compare(f"{mod.value} block table", (yr, yi, h, fd),
                dict(kw, blocks=blocks))
        print(f"phase 3 eq_demod_pack {mod.value} guard_bands={gb}: "
              f"B={yr.shape[0]} NB={yr.shape[1]} nbins={yr.shape[2]} "
              "bytes identical, payload exact; with a reversed block table "
              "identical")
        if mod is ott.Modulation.QAM64:
            compare("qam64 n_pilots=0", (yr, yi, h, fd), dict(kw, n_pilots=0))
            print("phase 3 eq_demod_pack qam64 guard bands with n_pilots=0 "
                  f"(nbins={yr.shape[2]}, n_data={nd}): bytes identical")
    return worst


def gates(out, data, name: str, cfo: bool) -> int:
    """The phase-4 gates: 0 payload byte errors clean, >= 95% of the rows
    exact with CFO.  Returns the exact rows."""
    n = data.shape[1]
    good = int((out[:, 16:16 + n] == data).all(dim=1).sum())
    if cfo:
        check(good >= 0.95 * data.shape[0],
              f"{name}: only {good}/{data.shape[0]} CFO rows exact")
    else:
        errs = int((out[:, 16:16 + n] != data).sum())
        check(errs == 0, f"{name}: {errs} payload byte errors on the clean batch")
    return good


def with_cfo(rx: torch.Tensor, gen, sym_len: int) -> torch.Tensor:
    """rx rotated by a per-row CFO drawn uniformly in [0, 0.9 pi / sym_len),
    inside the preamble estimator's range for this symbol length (the
    channel's own CFO is sized for 80-sample symbols)."""
    f = 0.9 * math.pi / sym_len * torch.rand(rx.shape[0], generator=gen,
                                             device=rx.device)
    n = torch.arange(1, rx.shape[1] + 1, device=rx.device, dtype=torch.float32)
    return rx * torch.polar(torch.ones_like(f[:, None] * n), f[:, None] * n)


def host_syncs(fn):
    """Run ``fn`` under torch.cuda.set_sync_debug_mode("warn"); return its
    result and the number of synchronizing CUDA calls it made."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def device_launches(fn) -> int:
    """Kernel launches and copies one call of ``fn`` puts on the device
    (torch.profiler, one session after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def ham_frames(gen, dev, n: int):
    """(user bytes [n, HAM_BYTES], frames [n, 19,040]): Hamming(7,4)-coded,
    QAM64, guard bands, made on the card."""
    data = torch.randint(0, 256, (n, HAM_BYTES), generator=gen, device=dev,
                         dtype=torch.uint8)
    return data, ott.encode_hamming(data, guard_bands=True, modulation=MOD)


def phase_streaming(gen, dev, name_limit: str) -> dict:
    """Phases 9-11: stream decoding at config 4 (see the module docstring).
    Returns the config-4 stream and the burst stream for phase 15."""
    cfg = ott.DEFAULT_CONFIG
    plen = coded_len(HAM_BYTES, "hamming")
    nb = ott.n_data_blocks(plen, MOD, True)
    flen = cfg.sync_len + nb * cfg.sym_len
    check((plen, nb, flen) == (8190, 228, 19040), f"config 4 geometry {plen, nb, flen}")
    data, tx = ham_frames(gen, dev, HAM_FRAMES)
    want = data.cpu().numpy()
    need = HAM_FRAMES * flen + cfg.sym_len           # bench.py's stream length
    s = pad_rows(ott.channel(tx.reshape(-1), snr=SNR, generator=gen)[None],
                 need)[0, :need]
    planes = torch.stack([s.real, s.imag])
    kw = dict(n_frames=HAM_FRAMES, spacing=flen, payload_len=plen,
              guard_bands=True, modulation=MOD, fec="hamming", data_len=HAM_BYTES)
    presync = launches(planar_align=1, eq_demod_pack=1)
    resync = launches(planar_align=1, sync_align=1, eq_demod_pack=1)
    routes = [("complex presync", s, dict(resync=False), presync),
              ("complex resync", s, dict(resync=True), resync)]
    routes += [(f"planar presync, handoff {h}", planes,
                dict(resync=False, planar_handoff=h), presync)
               for h in ("planar", "complex", "split")]
    routes.append(("planar resync", planes, dict(resync=True), resync))

    def gate(label, x, n_frames, spacing, extra, n_want, ref):
        (p, ok), n = counted(lambda: ott.decode_regular(
            x, **dict(kw, n_frames=n_frames, spacing=spacing), **extra))
        check(n == n_want, f"decode_regular {label} launched {n}, want {n_want}")
        errs = int((p != ref).sum())
        check(p.shape == ref.shape and errs == 0 and ok.all(),
              f"decode_regular {label}: {errs} byte errors")
        return p, n

    first_out = None
    for label, x, extra, n_want in routes:
        p, n = gate(label, x, HAM_FRAMES, flen, extra, n_want, want)
        first_out = p if first_out is None else first_out
        check(np.array_equal(p, first_out), f"decode_regular {label}: bytes "
              "differ from complex presync's")
        _, n_sync = host_syncs(lambda: ott.decode_regular(x, **kw, **extra))
        check(n_sync == 1, f"decode_regular {label}: {n_sync} synchronizing "
              "calls, want 1 (the output fetch)")
        print(f"phase 9 decode_regular {label}: {HAM_FRAMES} x {HAM_BYTES} B "
              f"Hamming QAM64, T={need}: 0 byte errors, bytes equal on every "
              f"route, launches {n}, synchronizing calls {n_sync}")

    # F1: the first frame at 523, 200 samples between frames, the stream
    # cut where the last frame ends as received (the channel's main tap
    # delays it); the JAX package's slice would overrun that end by
    # 200 - delay > sym_len samples and clamp its start
    delay = int(np.argmax(np.abs(constants.CHANNEL_TAPS)))
    spacing1, first1 = flen + 200, 523
    t1 = first1 + (HAM_FRAMES - 1) * spacing1 + flen + delay
    body = torch.zeros(first1 + HAM_FRAMES * spacing1, dtype=torch.complex64,
                       device=dev)
    body[first1:].view(HAM_FRAMES, spacing1)[:, :flen] = tx
    s1 = ott.channel(body, snr=SNR, generator=gen)[:t1]
    for label, extra, n_want in (("presync", dict(resync=False), presync),
                                 ("resync", dict(resync=True), resync)):
        _, n = gate(f"F1 stream {label}", s1, HAM_FRAMES, spacing1, extra,
                    n_want, want)
        print(f"phase 9 F1 stream (first {first1}, spacing {spacing1}, T={t1}) "
              f"{label}: 0 byte errors, launches {n}")

    # phase 10: decode_burst, then decode_continuous on its first 8 frames
    bdata, btx = ham_frames(gen, dev, BURST_FRAMES)
    gaps = torch.randint(300, 2201, (BURST_FRAMES,), generator=gen,
                         device=dev).tolist()
    parts, starts, pos = [], [], 0
    for i, g in enumerate(gaps):
        parts += [torch.zeros(g, dtype=torch.complex64, device=dev), btx[i]]
        starts.append(pos + g)
        pos += g + flen
    # the channel draws its CFO first; take the first seed whose CFO lies
    # below 0.8 pi / 80, inside the preamble estimator's range
    seed = next(k for k in range(100) if float(torch.rand(
        (), generator=torch.Generator(dev).manual_seed(k), device=dev)) < 0.8)
    bs = ott.channel(torch.cat(parts), snr=25.0, timing_error=True,
                     generator=torch.Generator(dev).manual_seed(seed))
    bkw = dict(payload_len=plen, guard_bands=True, modulation=MOD, fec="hamming",
               data_len=HAM_BYTES)
    found, n_burst = counted(lambda: ott.decode_burst(bs, **bkw))
    check(n_burst == launches(planar_align=1, eq_demod_pack=1),
          f"decode_burst launched {n_burst}")
    check(len(found) == BURST_FRAMES, f"decode_burst found {len(found)} frames")
    bwant = bdata.cpu().numpy()
    for (p, d, ok), st, w in zip(found, starts, bwant):
        check(abs(p - (st + delay)) <= 2, f"decode_burst: frame at {p}, sent at "
              f"{st} + the channel's {delay}-sample delay")
        check(ok and np.array_equal(d, w), f"decode_burst: frame at {p} has "
              f"{int((d != w).sum())} byte errors")
    _, n_bsync = host_syncs(lambda: ott.decode_burst(bs, **bkw))
    print(f"phase 10 decode_burst: {BURST_FRAMES} frames in T={bs.shape[0]} "
          f"(SNR 25, CFO, channel seed {seed}): all found within 2 samples, "
          f"0 byte errors; launches {n_burst}; synchronizing calls {n_bsync}")
    cont, n_cont = counted(
        lambda: list(ott.decode_continuous(bs, max_frames=8, **bkw)))
    check(n_cont == launches(sync_align=8, eq_demod_pack=8),
          f"decode_continuous launched {n_cont}")
    check([c[0] for c in cont] == [f[0] for f in found[:8]]
          and all(np.array_equal(c[1], f[1]) for c, f in zip(cont, found)),
          "decode_continuous differs from decode_burst")
    print(f"phase 10 decode_continuous, first 8 frames: decode_burst's positions "
          f"and bytes; launches {n_cont}")

    # phase 11: timing
    n_samples = HAM_FRAMES * flen
    print(f"phase 11 decode_regular per step on {name_limit} ({HAM_FRAMES} x "
          f"{flen}-sample frames, CUDA events median of {REPS}, each step "
          "ending in its output fetch; device busy from torch.profiler):")
    step_ms = {}
    for label, x, extra in (("complex presync", s, dict(resync=False)),
                            ("complex resync", s, dict(resync=True)),
                            ("planar presync", planes, dict(resync=False)),
                            ("planar resync", planes, dict(resync=True))):
        def step(x=x, extra=extra):
            return ott.decode_regular(x, **kw, **extra)
        ms = step_ms[label] = time_ms(step)
        dk = device_ms(step)
        busy = sum(dk.values())
        print(f"  {ms:.4f} ms/step, {n_samples / ms * 1e3:.4e} samples/s, busy "
              f"{busy:.4f} ms, idle share {1 - busy / ms:.3f}  {label} on "
              f"{name_limit}; top device items:")
        for kname, kms in sorted(dk.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {kms:.4f}  {kname[:100]}")
    # where the host time goes: the device work each step launches, and
    # the eager Hamming decode alone on the step's payload bytes
    step = lambda: ott.decode_regular(s, **kw, resync=False)   # noqa: E731
    payload = ott.decode_frame(s[:flen * HAM_FRAMES].view(HAM_FRAMES, flen),
                               n_blocks=nb, guard_bands=True,
                               modulation=MOD)[:, 16:16 + plen]
    ham = lambda: hamming.decode(payload, HAM_BYTES)          # noqa: E731
    ham_ms = time_ms(ham)
    ham_busy = sum(device_ms(ham).values())
    print(f"phase 11 host: complex presync puts {device_launches(step)} kernels "
          f"and copies on the device per step; the Hamming decode alone "
          f"{device_launches(ham)} kernels, {ham_ms:.4f} ms per call (CUDA "
          f"events), busy {ham_busy:.4f} ms, on {name_limit}")
    offs = torch.arange(HAM_FRAMES, device=dev) * flen
    k3 = sum(device_ms(lambda: planar_align(s, offs, flen, planar=True)).values())
    k3_plain = sum(device_ms(
        lambda: planar_align_reference(s, offs, flen, planar=True)).values())
    k3_bound, _ = bound(0, 2 * HAM_FRAMES * flen * 8 + HAM_FRAMES * 8)
    print(f"phase 11 planar_align shared stream ({HAM_FRAMES} rows of {flen} "
          f"from T={need}): {k3:.4f} ms/call, plain {k3_plain:.4f}, bound "
          f"{k3_bound:.4f} (bytes), share {k3_bound / k3:.3f} on {name_limit}")
    return {"stream": s, "want": want, "kw": kw, "burst": bs, "burst_kw": bkw,
            "burst_found": found, "step_ms": step_ms}


def phase_serving(dev, name_limit: str, n_frames: int) -> None:
    """Phase 12: serving at config 5 (see the module docstring), with
    ``n_frames`` frames a buffer."""
    t_phase = time.perf_counter()
    check(rs._LIB is not None and capture_mod._LIB is not None,
          "the native RS codec and IQ loader must be loaded")
    bufs, pixels = serving.synth_buffers(SRV_DISTINCT, n_frames, device=dev)
    host = [b.cpu().numpy() for b in bufs]
    t_buf = serving.buffer_len(n_frames)
    flen = serving.FLEN
    n_buf = SRV_DISTINCT * SRV_ROUNDS
    order = [i % SRV_DISTINCT for i in range(n_buf)]
    per_step = launches(planar_align=1, sync_align=1, eq_demod_pack=1)

    # one serve step: its launches, no synchronizing call before the fetch
    raw, n_step = counted(lambda: serving.serve_step(bufs[1], n_frames))
    check(n_step == per_step, f"serve_step launched {n_step}, want {per_step}")
    _, n_sync = host_syncs(lambda: serving.serve_step(bufs[1], n_frames))
    check(n_sync == 0, f"serve_step made {n_sync} synchronizing calls")
    _, n_sync_fetch = host_syncs(
        lambda: fetch_async(serving.serve_step(bufs[1], n_frames)))
    check(n_sync_fetch == 0, f"serve_step + fetch_async made {n_sync_fetch} "
          "synchronizing calls")
    # K3 and K1 against their plain versions at the serving shape
    first = streaming_mod._first_sync(bufs[1], spacing=flen,
                                      cfg=serving.CFG).clamp(min=0)
    offs = first + torch.arange(n_frames, device=dev) * flen
    rows = planar_align(bufs[1], offs, flen, planar=True)
    rows_ref = planar_align_reference(bufs[1], offs, flen, planar=True)
    torch.cuda.synchronize()
    check(torch.equal(rows, rows_ref), "planar_align at the serving shape "
          "differs from plain")
    template = constants.locking_for(serving.CFG)
    win, off = sync_align(rows, template, flen,
                          search_window=serving.CFG.sym_len, planar=True)
    win_ref, off_ref = sync_align_reference(rows, template, flen,
                                            search_window=serving.CFG.sym_len,
                                            planar=True)
    torch.cuda.synchronize()
    check(torch.equal(off, off_ref) and torch.equal(win, win_ref),
          "sync_align at the serving shape differs from plain")
    print(f"phase 12 serve_step on {n_frames} x {flen}-sample "
          f"frames (T={t_buf}): launches {n_step}; synchronizing "
          f"calls {n_sync} (with the async fetch {n_sync_fetch}); K3 "
          f"{n_frames} rows from the stream and K1 on [{n_frames}, "
          f"2, {flen}] with search window {serving.CFG.sym_len} "
          "identical to plain; native RS codec and IQ loader loaded")

    def drive(buffers) -> dict:
        """Serve ``buffers`` (the 48 in ``order``); every image must be its
        transmitted pixels.  Returns the mode's numbers."""
        lat, rs_s, col_s = [], [], []
        t0 = time.perf_counter()
        for sv in serving.serve(buffers, n_frames, in_flight=SRV_IN_FLIGHT):
            want = pixels[order[sv.index]]
            bad = int((sv.pixels != want).any(axis=1).sum())
            check(bad == 0 and sv.ok.all(), f"buffer {sv.index}: {bad} of "
                  f"{n_frames} images differ, RS ok {int(sv.ok.sum())}")
            lat.append(sv.latency_s)
            rs_s.append(sv.rs_s)
            col_s.append(sv.colors_s)
        wall = time.perf_counter() - t0
        check(len(lat) == n_buf, f"served {len(lat)} buffers, want {n_buf}")
        lat_ms = np.asarray(lat) * 1e3
        return {"ms": wall / n_buf * 1e3, "samples_s": n_buf * t_buf / wall,
                "frames_s": n_buf * n_frames / wall,
                "p50": float(np.percentile(lat_ms, 50)),
                "p99": float(np.percentile(lat_ms, 99)),
                "rs_ms": statistics.median(rs_s) * 1e3,
                "colors_ms": statistics.median(col_s) * 1e3}

    up = Uploader(dev)
    up_planar = Uploader(dev, planar=True)

    def feed_mode():
        with SampleFeed(host[b] for b in order) as feed:
            return drive(double_buffered(feed, up))

    def resident_mode():
        return drive(bufs[b] for b in order)

    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / f"buffer{b}.dat" for b in range(SRV_DISTINCT)]
        for path, h in zip(paths, host):
            iqfile.write_iq(path, h)

        def capture_planes():
            for b in order:
                with capture_mod.Capture(paths[b]) as cap:
                    yield next(cap.chunks(t_buf))

        def planar_mode():
            with SampleFeed(capture_planes()) as feed:
                return drive(double_buffered(feed, up_planar))

        # one buffer: file -> Capture.chunks -> to_device_planar, the same
        # bytes as the complex buffer's
        with capture_mod.Capture(paths[1]) as cap:
            chunks = list(cap.chunks(t_buf))
        check(len(chunks) == 1 and chunks[0][0].size == t_buf,
              "Capture.chunks did not give the buffer whole")
        planes = to_device_planar(chunks[0], device=dev)
        check(torch.equal(serving.serve_step(planes, n_frames), raw),
              "planar capture bytes differ from the complex buffer's")
        modes = {"feed (capture thread, pinned double-buffered upload)": feed_mode,
                 "device-resident": resident_mode,
                 "planar capture (fc32 file, Capture, planar upload)": planar_mode}
        results = {}
        for label, fn in modes.items():
            fn()                                      # warm-up, checked too
            res, n = counted(fn)
            want = launches(planar_align=n_buf, sync_align=n_buf,
                            eq_demod_pack=n_buf)
            check(n == want, f"serving {label} launched {n}, want {want}")
            results[label] = res
            print(f"phase 12 serving {label}: {n_buf} buffers, every image of "
                  f"every buffer exact; launches {n}")

    # rx_stream on the card: the per-buffer route and the burst route
    for extra in ([], ["--continuous"]):
        rc = rx_stream.main(["--buffers", "3", "--buffer-len", "65536",
                             "--device", "cuda", *extra])
        check(rc == 0, f"rx_stream {extra} returned {rc}")
    print("phase 12 rx_stream --device cuda: 3 buffers decoded, per buffer "
          "and --continuous")

    # the parts, one at a time
    def h2d(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return median_s(run)

    up_s = h2d(lambda: up(host[0]))
    page_s = h2d(lambda: torch.from_numpy(host[0]).to(dev))
    nbytes = host[0].nbytes

    def step():
        return fetch_async(serving.serve_step(bufs[0], n_frames)).result()
    step_ms = time_ms(step)
    done = serving.serve_step(bufs[0], n_frames)
    torch.cuda.synchronize()
    fetch_s = median_s(lambda: fetch_async(done).result())
    raw_np = fetch_async(done).result()
    rs_s = median_s(lambda: rs.decode_payload_rows(raw_np, serving.USER_BYTES))
    data_np, _ = rs.decode_payload_rows(raw_np, serving.USER_BYTES)
    col_s = median_s(lambda: id_to_rgb(data_np.reshape(-1)))
    dk = device_ms(lambda: serving.serve_step(bufs[0], n_frames))
    busy = sum(dk.values())
    n_dev = device_launches(lambda: serving.serve_step(bufs[0], n_frames))
    # K3 and K1 at the serving shape: device time beside plain and bound
    # (each input read once, each output written once; K1's correlation
    # scans search_window + K lags of each row)
    sw = serving.CFG.sym_len
    k3 = sum(device_ms(lambda: planar_align(bufs[1], offs, flen,
                                            planar=True)).values())
    k3_plain = sum(device_ms(lambda: planar_align_reference(
        bufs[1], offs, flen, planar=True)).values())
    k1 = sum(device_ms(lambda: sync_align(rows, template, flen,
                                          search_window=sw,
                                          planar=True)).values())
    k1_plain = sum(device_ms(lambda: sync_align_reference(
        rows, template, flen, search_window=sw,
        planar=True)).values())
    n_rows = n_frames
    k3_bound = bound(0, n_rows * flen * (8 + 8) + n_rows * 4)
    k1_bound = bound(n_rows * (sw + len(template)) * len(template) * 2 * 2,
                     n_rows * flen * (8 + 8) + n_rows * 4)
    for name, ms, plain, (b_ms, b_by) in (("planar_align (K3)", k3, k3_plain,
                                          k3_bound),
                                         ("sync_align (K1)", k1, k1_plain,
                                          k1_bound)):
        print(f"phase 12 {name} at the serving shape: {ms:.4f} ms/call, "
              f"plain {plain:.4f}, bound {b_ms:.4f} ({b_by}), share "
              f"{b_ms / ms:.3f} on {name_limit}")
    serial = up_s * 1e3 + step_ms + (rs_s + col_s) * 1e3
    feed_ms = results[next(iter(modes))]["ms"]
    print(f"phase 12 timing on {name_limit} ({n_buf} buffers of "
          f"{t_buf} samples, {SRV_IN_FLIGHT} in flight, host clock; "
          "latency from a step's enqueue to the end of its host tail):")
    for label, r in results.items():
        print(f"  {r['ms']:.4f} ms/buffer, {r['samples_s']:.4e} samples/s, "
              f"{r['frames_s']:.1f} image frames/s, latency p50 {r['p50']:.4f} "
              f"p99 {r['p99']:.4f} ms, in-loop tail RS {r['rs_ms']:.4f} + "
              f"colorspace {r['colors_ms']:.4f} ms  {label} on {name_limit}")
    print(f"phase 12 H2D of one buffer ({nbytes} B): pinned ring "
          f"{up_s * 1e3:.4f} ms ({nbytes / up_s / 1e9:.3f} GB/s, host copy into "
          f"the slot included), pageable .to(cuda) {page_s * 1e3:.4f} ms "
          f"({nbytes / page_s / 1e9:.3f} GB/s) on {name_limit}")
    print(f"phase 12 fetch of the payload slice ({raw_np.nbytes} B): "
          f"{fetch_s * 1e3:.4f} ms; host tail alone RS {rs_s * 1e3:.4f} ms + "
          f"colorspace {col_s * 1e3:.4f} ms per buffer on {name_limit}")
    print(f"phase 12 serve step + fetch {step_ms:.4f} ms (CUDA events, median "
          f"of {REPS}); device busy {busy:.4f} ms, idle share "
          f"{1 - busy / step_ms:.3f}; {n_dev} kernels and copies per step "
          f"(torch.profiler) on {name_limit}; top device items:")
    for kname, kms in sorted(dk.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {kms:.4f}  {kname[:100]}")
    print(f"phase 12 serial sum upload {up_s * 1e3:.4f} + step {step_ms:.4f} + "
          f"tail {(rs_s + col_s) * 1e3:.4f} = {serial:.4f} ms against feed "
          f"mode's {feed_ms:.4f} ms/buffer (overlap {serial / feed_ms:.3f}x) "
          f"on {name_limit}")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


def tf32_flags() -> str:
    """Which of PyTorch's two interfaces ``set_full_fp32`` wrote, and what
    the flags read now (the other interface is not read: PyTorch may refuse
    a legacy read after a write of the new one)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    if hasattr(matmul, "fp32_precision"):
        return (f"fp32_precision: cuda.matmul={matmul.fp32_precision!r} "
                f"cudnn.conv={cudnn.conv.fp32_precision!r}")
    return f"allow_tf32: cuda.matmul={matmul.allow_tf32} cudnn={cudnn.allow_tf32}"


GOLDEN = ROOT / "tests" / "golden"
CAPTURES = (("rx_capture_qam64", ott.Modulation.QAM64),
            ("torch_capture_qam256", ott.Modulation.QAM256),
            ("torch_capture_bpsk_gb", ott.Modulation.BPSK))
# the modulations' operating SNRs (tools/exp_modmatrix_tpu.py:38-40)
OPERATING_SNR = {ott.Modulation.BPSK: 45.0, ott.Modulation.QPSK: 45.0,
                 ott.Modulation.QAM16: 45.0, ott.Modulation.QAM64: 45.0,
                 ott.Modulation.QAM256: 55.0}
# Es/N0 points of tests/test_ber_theory.py, where BER sits in 2e-3 .. 3e-2
THEORY_SNRS = {"bpsk": [4.0, 7.0], "qpsk": [7.0, 10.0], "qam16": [12.0, 15.0],
               "qam64": [18.0, 21.0], "qam256": [24.0, 27.0]}


def load_capture(name: str):
    """(rows complex64 [R, T], the bytes JAX's decode_frame gave [R, n],
    n_blocks, the payload JAX's decode gave for row 0) of a frozen capture,
    read with the port's ``read_iq``."""
    if name == "rx_capture_qam64":
        exp = np.load(GOLDEN / "rx_capture_expected.npz")
        rows = iqfile.read_iq(GOLDEN / f"{name}.dat", dtype=np.complex64)[None]
        return rows, exp["decoded"][None], int(exp["n_blocks"]), exp["payload"]
    exp = np.load(GOLDEN / f"{name}.npz")
    rows = iqfile.read_iq(GOLDEN / f"{name}.dat", dtype=np.complex64).reshape(
        -1, int(exp["row_len"]))
    return rows, exp["decoded"], int(exp["n_blocks"]), exp["decode_payload"]


GUARD_PRELUDE = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from ofdm_tpu_torch.ops.fft import require_full_fp32
matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
assert torch.cuda.is_available()
"""
GUARD_CHECK = """
try:
    require_full_fp32(torch.device("cuda"))
    print("passes")
except RuntimeError as e:
    assert "ofdm_tpu_torch needs full-fp32" in str(e), e
    print("raises")
"""
# one real decode with TF32 turned off through fp32_precision alone
GUARD_DECODE = """
import ofdm_tpu_torch as ott
from ofdm_tpu_torch.io.iqfile import read_iq
golden = sys.argv[1] + "/tests/golden/torch_capture_qam256"
exp = np.load(golden + ".npz")
rows = read_iq(golden + ".dat", dtype=np.complex64).reshape(-1, int(exp["row_len"]))
out = ott.decode_frame(torch.as_tensor(rows).cuda(), n_blocks=int(exp["n_blocks"]),
                       guard_bands=True, modulation=ott.Modulation.QAM256)
assert np.array_equal(out.cpu().numpy(), exp["decoded"]), "bytes differ"
print("decoded")
"""
# name -> (what the process sets, the expected lines, needs fp32_precision)
GUARD_CASES = {
    "defaults": ("", ["raises"], False),
    "legacy flags off": ("matmul.allow_tf32 = False; cudnn.allow_tf32 = False",
                         ["passes"], False),
    "new api ieee, then decode_frame":
        ('matmul.fp32_precision = "ieee"; cudnn.conv.fp32_precision = "ieee"',
         ["passes", "decoded"], True),
    "new api tf32":
        ('matmul.fp32_precision = "tf32"; cudnn.conv.fp32_precision = "tf32"',
         ["raises"], True),
    "mixed, conv left on":
        ('matmul.fp32_precision = "ieee"; cudnn.allow_tf32 = True', ["raises"], True),
}


def guard_on_the_card() -> list[str]:
    """Fault F9 on the card: the guard in a process of its own under each
    way of setting the flags (all started together); returns the verdicts."""
    new_api = hasattr(torch.backends.cuda.matmul, "fp32_precision")
    procs = {}
    for name, (setting, want, needs_new) in GUARD_CASES.items():
        if needs_new and not new_api:
            continue
        code = GUARD_PRELUDE + setting + "\n" + GUARD_CHECK \
            + (GUARD_DECODE if "decoded" in want else "")
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    verdicts = []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        want = GUARD_CASES[name][1]
        check(proc.returncode == 0 and out.split() == want,
              f"guard case {name!r}: got {out.split()} rc {proc.returncode}, "
              f"want {want}\n{err[-2000:]}")
        verdicts.append(f"{name}: {' + '.join(want)}")
    check(new_api or len(verdicts) == 2, "guard cases")
    return verdicts


def phase_captures(dev, n_plain_decode: dict) -> None:
    """Phase 13: the frozen captures and the decode diagnostics (see the
    module docstring).  ``n_plain_decode``: phase 4's launch counts of one
    ``decode``."""
    t_phase = time.perf_counter()
    cfg = ott.DEFAULT_CONFIG
    template = constants.locking_for(cfg)
    one_each = launches(sync_align=1, eq_demod_pack=1)
    check(n_plain_decode == one_each, f"phase 4's decode launched {n_plain_decode}")
    for name, mod in CAPTURES:
        rows, decoded, nb, payload = load_capture(name)
        x = torch.as_tensor(rows).to(dev)
        want = torch.as_tensor(decoded).to(dev)
        reps = BATCH // x.shape[0]
        kw = dict(n_blocks=nb, guard_bands=True, modulation=mod)
        for label, xx, ww in (("as stored", x, want),
                              (f"tiled to {reps * x.shape[0]} rows",
                               x.repeat(reps, 1), want.repeat(reps, 1))):
            out, n = counted(lambda: ott.decode_frame(xx, **kw))
            check(n == one_each, f"{name} {label}: launched {n}")
            bad = int((out != ww).any(dim=1).sum())
            check(torch.equal(out, ww), f"{name} {label}: {bad} of {ww.shape[0]} "
                  "rows differ from the bytes the JAX package decoded")
            print(f"phase 13 {name} ({mod.value}, {x.shape[0]} x {x.shape[1]} "
                  f"samples, n_blocks {nb}) decode_frame {label}: bytes equal "
                  f"the JAX package's on {ww.shape[0]}/{ww.shape[0]} rows; "
                  f"launches {n}")
        dkw = dict(guard_bands=True, modulation=mod)
        (pay, diag), n_diag = counted(lambda: ott.decode(
            rows[0], device=dev, return_diagnostics=True, **dkw))
        pay_plain, n_plain = counted(lambda: ott.decode(rows[0], device=dev, **dkw))
        check(n_plain == n_plain_decode and n_diag == n_plain_decode,
              f"{name}: decode launched {n_plain}, with diagnostics {n_diag}, "
              f"phase 4's {n_plain_decode}")
        check(np.array_equal(pay, payload) and np.array_equal(pay_plain, payload),
              f"{name}: decode's payload differs from the JAX package's")
        need = (cfg.n_sync_chunks + nb) * cfg.sym_len
        _, raw = sync_align(x[:1], template, need, planar=True)
        check(diag["offset"] == max(int(raw[0]), 0),
              f"{name}: decode offset {diag['offset']}, decode_frame's sync "
              f"{int(raw[0])}")
        _, cdiag = ott.decode(rows[0], device="cpu", return_diagnostics=True, **dkw)
        check(set(diag) == set(cdiag) == {"chunk6_pre", "chunk6_post", "h_k",
                                          "equalized", "f_delta", "offset"},
              f"{name}: diag keys {sorted(diag)}")
        check(diag["offset"] == cdiag["offset"], f"{name}: offset differs on the CPU")
        worst = 0.0
        for key, w in cdiag.items():
            if key == "offset":
                continue
            g = diag[key]
            check(isinstance(g, np.ndarray) and g.shape == w.shape
                  and g.dtype == w.dtype, f"{name}: diag[{key!r}] {g.shape} {g.dtype}")
            rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-3))
            worst = max(worst, rel)
            check(rel < 1e-4, f"{name}: diag[{key!r}] differs from the CPU's by {rel}")
        print(f"phase 13 {name} decode(return_diagnostics=True) on row 0: payload "
              f"equals the JAX package's, offset {diag['offset']} = decode_frame's "
              f"sync, keys and shapes as on the CPU (equalized "
              f"{diag['equalized'].shape}), signals within {worst:.2e} of the "
              f"CPU's; launches {n_diag} with, {n_plain} without diagnostics")
    for verdict in guard_on_the_card():
        print(f"phase 13 full-fp32 guard in a process of its own, {verdict}")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


def cfo_seed(dev, below: float = 0.6) -> int:
    """The first seed whose generator on ``dev`` draws the channel's CFO
    below ``below`` pi / 80, inside the reference estimator's range (the
    channel draws its CFO first)."""
    return next(k for k in range(100) if float(torch.rand(
        (1,), generator=torch.Generator(dev).manual_seed(k), device=dev)) < below)


def run_app(app, args: list) -> str:
    """``app.main(args)`` with its output captured; a non-zero return code
    fails the run.  Returns what it printed."""
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown):
        rc = app.main([str(a) for a in args])
    name = app.__name__.rsplit(".", 1)[-1]
    check(rc == 0, f"{name} {args} returned {rc}:\n{shown.getvalue()[-2000:]}")
    return shown.getvalue()


def phase_apps(dev, name_limit: str) -> None:
    """Phase 14: the apps on the card and the per-modulation timing (see the
    module docstring)."""
    t_phase = time.perf_counter()
    cuda = ["--device", "cuda"]
    one_each = launches(sync_align=1, eq_demod_pack=1)

    # ber_sweep.measure_ber at the headline width
    print(f"phase 14 ber_sweep.measure_ber on {name_limit}: {BATCH} x {PAYLOAD} B, "
          "guard bands, host clock per point (numpy payloads, upload, encode, "
          "channel, decode_frame, bit-error count, one fetch):")
    for mod, snr_op in OPERATING_SNR.items():
        bers, secs = [], []
        for snr in (snr_op, 5.0):
            # the warm-up call pays cuDNN's and cuBLAS's first-shape set-up
            point = lambda: ber_sweep.measure_ber(       # noqa: E731
                mod, snr, batch=BATCH, payload=PAYLOAD, guard_bands=True,
                cfo=False, seed=int(snr * 10) + 7, device=dev)
            point()
            t0 = time.perf_counter()
            ber, n = counted(point)
            secs.append(time.perf_counter() - t0)
            check(n == one_each, f"measure_ber {mod.value} @ {snr} launched {n}")
            bers.append(ber)
        check(bers[0] == 0.0, f"{mod.value}: BER {bers[0]} at SNR {snr_op}")
        check(bers[1] > 0.0, f"{mod.value}: BER {bers[1]} at SNR 5")
        print(f"  {mod.value}: BER 0 at SNR {snr_op:g} ({secs[0] * 1e3:.4f} ms), "
              f"{bers[1]:.6f} at SNR 5 ({secs[1] * 1e3:.4f} ms); launches per "
              f"point {n}")
    for name, snrs in THEORY_SNRS.items():
        out = run_app(ber_sweep, ["--awgn-theory", "--json", "--modulations",
                                  name, "--snrs", *snrs, *cuda])
        rows = json.loads(out.strip().splitlines()[-1])["awgn"][name]
        for row in rows:
            check(0.8 * row["theory"] < row["measured"] < 1.2 * row["theory"]
                  and row["theory"] == ber_theory.ber_awgn(
                      ott.Modulation(name), row["snr"]),
                  f"ber_sweep --awgn-theory {name}: {row}")
        print(f"phase 14 ber_sweep --awgn-theory {name} at Es/N0 {snrs}: measured "
              + ", ".join(f"{r['measured']:.4e} (theory {r['theory']:.4e})"
                          for r in rows) + ", within 20%")

    seed = cfo_seed(dev)
    cwd = os.getcwd()
    for k in KERNELS.values():
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            out = run_app(lab3a, ["--ecc", "--guard-bands", "--cfo", "--taps",
                                  "--seed", seed, *cuda])
            check("I met a traveller from an antique land" in out
                  and "errs=0" in out, f"lab3a: {out[-500:]}")
            tap_names = ["transmitted_3a", "channeled_3a", "preq_correction_3a",
                         "post_correction_3a", "hk_estimate_3a", "no_phaseoffset"]
            check(sorted(os.listdir("data/simulated")) == sorted(
                f"{n}_{part}.npy" for n in tap_names for part in ("reals", "imag")),
                f"lab3a taps: {os.listdir('data/simulated')}")
            print(f"phase 14 lab3a --ecc --guard-bands --cfo --taps --seed {seed}: "
                  "the text recovered with 0 bit errors, six taps written")
            out = run_app(lab3b, ["--guard-bands", "--seed", seed, *cuda])
            check("I met a traveller" in out, f"lab3b: {out[-500:]}")
            run_app(lab3c, ["--transmit", "tx.dat", *cuda])
            out = run_app(lab3c, ["--receive", "tx.dat", *cuda])
            check("I met a traveller" in out and "errs=0" in out,
                  f"lab3c: {out[-500:]}")
            out = run_app(monitor, ["--buffers", 2, "--no-clear", *cuda])
            check(out.count("decode ok") == 2, f"monitor: {out[-800:]}")
            print("phase 14 lab3b, lab3c --transmit then --receive (0 bit errors), "
                  "monitor --buffers 2 (decode ok twice)")
            image = seeded_image(24, 24).tobytes()
            out = run_app(lab3b_image, ["--snr", 28, "--seed", seed, *cuda])
            check("errs=0" in out, f"lab3b_image: {out[-500:]}")
            run_app(lab3c_image, ["--transmit", "img.dat", *cuda])
            run_app(lab3c_image, ["--receive", "img.dat", "--out-bytes",
                                  "img.bytes", *cuda])
            check(Path("img.bytes").read_bytes() == image,
                  "lab3c_image: the recovered ids differ from the seeded image")
            print("phase 14 lab3b_image and lab3c_image: the recovered ids equal "
                  "the seeded 24 x 24 image")
            run_app(stream_bytes, ["--out-dir", "dance", *cuda])
            files = sorted(str(f) for f in Path("dance").iterdir())
            check(len(files) == 8, f"stream_bytes wrote {files}")
            out = run_app(rx_stream, ["--files", *files, *cuda])
            check("8 frames ok, 0 skipped" in out, f"rx_stream: {out[-500:]}")
            run_app(transmitloop, ["--iterations", 3, "--out", "loop.dat", *cuda])
            check(os.path.getsize("loop.dat") == 3 * os.path.getsize(files[0]),
                  "transmitloop: file size")
            out = run_app(rx_stream, ["--files", "loop.dat", *cuda])
            check("1 frames ok" in out, f"rx_stream on the loop: {out[-500:]}")
            out = run_app(rx_stream, ["--files", "loop.dat", "--continuous", *cuda])
            # the burst scan finds 2 of 3 frames that follow one another
            # without a gap, as the JAX package's does on the same file
            check("continuous stream done: 2 frames" in out
                  or "continuous stream done: 3 frames" in out,
                  f"rx_stream --continuous on the loop: {out[-500:]}")
            out = run_app(datatoframe, [])
            check(out.count("\x1b[48;2;") == 24 * 24, "datatoframe preview")
            out = run_app(probe, cuda)
            check(torch.cuda.get_device_name(0) in out
                  and "matmul smoke test: OK" in out, f"probe: {out}")
            print("phase 14 stream_bytes -> 8 files -> rx_stream --files (8 frames "
                  "ok); transmitloop --iterations 3 -> rx_stream (1 frame a "
                  "buffer) and rx_stream --continuous; datatoframe; "
                  f"probe: {out.splitlines()[2].strip()}")
        finally:
            os.chdir(cwd)
    n_apps = {name: k.launches for name, k in KERNELS.items()}
    # lab3a, lab3b, lab3c, 2 monitor buffers, 2 image apps, 8 + 1 rx_stream
    # buffers: one decode each (K1 1 + K2 1); the --continuous buffer goes
    # through decode_burst (K3 1 + K2 1)
    check(n_apps == launches(sync_align=16, eq_demod_pack=17, planar_align=1),
          f"the apps launched {n_apps}")
    print(f"phase 14 kernel launches of the apps above: {n_apps}")
    set_up_logging("chip_smoke")       # the apps' log handlers wrote to run_app's buffers

    # per modulation: one byte-gated batch, then the step times
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for mod, snr in OPERATING_SNR.items():
            nb = ott.n_data_blocks(PAYLOAD, mod, True)
            row_len = ott.DEFAULT_CONFIG.sync_len + 80 + nb * 80
            data = torch.randint(0, 256, (BATCH, PAYLOAD), dtype=torch.uint8,
                                 device=dev,
                                 generator=torch.Generator(dev).manual_seed(SEED))
            enc = lambda: ott.encode(data, guard_bands=True,    # noqa: E731
                                     modulation=mod)
            rx = pad_rows(ott.channel(enc(), snr=snr,
                                      generator=torch.Generator(dev).manual_seed(1)),
                          row_len)
            kw = dict(n_blocks=nb, guard_bands=True, modulation=mod)
            out, n = counted(lambda: ott.decode_frame(rx, **kw))
            check(n == one_each, f"decode_frame {mod.value} launched {n}")
            check(tuple(rx.shape) == (BATCH, row_len), f"{mod.value} rows {rx.shape}")
            gates(out, data, f"decode_frame {mod.value}", cfo=False)
            dec_ms = time_ms(lambda: ott.decode_frame(rx, **kw))
            enc_ms = time_ms(enc)
            results.append((mod, snr, nb, row_len, dec_ms, enc_ms))
            if mod is MOD:
                headline = (rx, kw)
            del rx, out, data
        # the profiler hooks around two steps of the headline shape, after
        # the timing (a profiler session may leave the host slower than it
        # was).  Two steps: the profiler was seen to drop the record of a
        # kernel launched within microseconds of the session's start
        rx, kw = headline
        with profiler.trace(tmp), profiler.annotate("decode_frame steps"), \
                profiler.timed("decode_frame steps"):
            ott.decode_frame(rx, **kw)
            ott.decode_frame(rx, **kw)
        trace = Path(tmp) / profiler.TRACE_NAME
        events = json.loads(trace.read_text())["traceEvents"]
        names = [e.get("name", "") for e in events]
        seen = {kernel: sum(kernel in n for n in names)
                for kernel in ("corr_argmax_kernel", "window_kernel",
                               "eq_demod_pack_kernel")}
        check(all(seen.values()) and "decode_frame steps" in names,
              f"the chrome trace names the kernels {seen} times; its events by "
              f"category: { {c: sum(e.get('cat') == c for e in events) for c in {e.get('cat') for e in events}} }")
        print(f"phase 14 profiler.trace around two decode_frame steps: "
              f"{trace.stat().st_size} B chrome trace, {len(events)} events; "
              f"sync_align's and eq_demod_pack's kernels named {seen} times; "
              "timed and annotate ran")
    print(f"phase 14 timing on {name_limit}: {BATCH} x {PAYLOAD} B payloads, guard "
          f"bands, CUDA events median of {REPS}, each batch decoded with 0 byte "
          "errors in this run:")
    for mod, snr, nb, row_len, dec_ms, enc_ms in results:
        n_samples = BATCH * row_len
        print(f"  {mod.value}: SNR {snr:g}, n_blocks {nb}, rows of {row_len} samples: "
              f"decode_frame {dec_ms:.4f} ms/step, {n_samples / dec_ms * 1e3:.4e} "
              f"samples/s; encode {enc_ms:.4f} ms/step, "
              f"{BATCH * (row_len - 80) / enc_ms * 1e3:.4e} samples/s on {name_limit}")
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")


# the 1-process and 2-process CPU worlds of the pipeline step (gloo):
# per-rank batch, payload and steps
CPU_WORLD_ROWS = 8
CPU_WORLD_PAYLOAD = 64
CPU_WORLD_STEPS = 11


def cpu_worlds(name_limit: str) -> None:
    """The pipeline step in a 1-process world (mesh 1 x 1) and in 2-process
    worlds (2 x 1 with twice the rows, 1 x 2 with the same rows), gloo on
    the host's CPU: the mechanism across a process boundary, and each
    world's wall time per step (median of the steps after the first).  At
    this size Python and localhost overheads make up the step, and the CPU
    is shared: the times are no scaling point."""
    rng = np.random.default_rng(SEED)
    kw = dict(payload_len=CPU_WORLD_PAYLOAD, guard_bands=True,
              modulation="qpsk", snr=30.0, timing_error=True, seed=3,
              steps=CPU_WORLD_STEPS)
    for n_procs, mesh, rows in ((1, (1, 1), CPU_WORLD_ROWS),
                                (2, (2, 1), 2 * CPU_WORLD_ROWS),
                                (2, (1, 2), CPU_WORLD_ROWS)):
        data = rng.integers(0, 256, (rows, CPU_WORLD_PAYLOAD), dtype=np.uint8)
        spec = {"cases": [dict(name="pipe", kind="pipeline", mesh=list(mesh),
                               kw=kw)]}
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            reports, outputs = world_mod.World(
                spec, {"pipe/data": data}, n_procs, tmp,
                device="cpu").wait(timeout=240)
            wall = time.perf_counter() - t0
        decoded = world_mod.rows(reports, outputs, "pipe", "decoded")
        errs = world_mod.replicated(reports, outputs, "pipe", "errs")
        check(errs.tolist() == [0] * CPU_WORLD_STEPS and np.array_equal(
            decoded[:, 16:16 + CPU_WORLD_PAYLOAD], data),
              f"CPU world {mesh}: bit errors {errs.tolist()}")
        steps = np.stack([o["pipe/step_s"] for o in outputs])
        ms = float(np.median(steps[:, 1:].max(axis=0))) * 1e3
        inv = reports[0]["cases"]["pipe"]["counts"]
        print(f"phase 15 CPU, gloo: {n_procs} process(es), mesh {mesh}, "
              f"{rows} x {CPU_WORLD_PAYLOAD} B QPSK pipeline steps: 0 bit "
              f"errors in {CPU_WORLD_STEPS} steps, {ms:.4f} ms/step (wall, "
              f"median of {CPU_WORLD_STEPS - 1} after the first, slowest "
              f"rank); rank 0's collectives over the steps {inv}; world "
              f"{wall:.1f} s with start-up; host of {name_limit}")


# the one-rank NCCL world of the pipeline step: steps in the worker
NCCL_WORLD_STEPS = 5


def nccl_world(name_limit: str, data: np.ndarray) -> None:
    """The pipeline step at the headline width in a one-rank world of
    ``parallel.dist_worker`` on its default route (NCCL, cuda:0), in a
    process of its own: 0 bit errors and the payloads back in every step,
    sync_keys 1 + K3 1 a step by the worker's own counters, and no
    all_gather."""
    kw = dict(payload_len=PAYLOAD, guard_bands=True, modulation=MOD.value,
              snr=SNR, timing_error=True, seed=SEED, steps=NCCL_WORLD_STEPS)
    spec = {"cases": [dict(name="pipe", kind="pipeline", mesh=[1, 1], kw=kw)]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reports, outputs = world_mod.World(spec, {"pipe/data": data}, 1,
                                           tmp).wait(timeout=300)
        wall = time.perf_counter() - t0
    rep = reports[0]["cases"]["pipe"]
    errs = outputs[0]["pipe/errs"]
    check(reports[0]["world"] == 1 and errs.tolist() == [0] * NCCL_WORLD_STEPS
          and np.array_equal(outputs[0]["pipe/decoded"][:, 16:16 + PAYLOAD],
                             data), f"NCCL world: bit errors {errs.tolist()}")
    check(rep["launches"] == launches(sync_keys=NCCL_WORLD_STEPS,
                                      planar_align=NCCL_WORLD_STEPS),
          f"NCCL world launched {rep['launches']}")
    check(rep["counts"]["all_gather"]["calls"] == 0,
          f"NCCL world collectives {rep['counts']}")
    ms = float(np.median(outputs[0]["pipe/step_s"][1:])) * 1e3
    print(f"phase 15 dist_worker, one rank on its default route (NCCL, "
          f"cuda:0), {BATCH} x {PAYLOAD} B QAM64 pipeline steps: 0 bit errors "
          f"in {NCCL_WORLD_STEPS} steps, payloads exact; worker launches "
          f"{rep['launches']}; collectives {rep['counts']}; {ms:.4f} ms/step "
          f"(wall, median of {NCCL_WORLD_STEPS - 1} after the first, each "
          f"ending in its error count's fetch); world {wall:.1f} s with "
          f"start-up on {name_limit}")


def phase_parallel(dev, name_limit: str, head: dict, streams: dict) -> dict:
    """Phase 15: parallel/ on the card (see the module docstring).  Returns
    the sync_keys entry's measurements for the kernels line."""
    t_phase = time.perf_counter()
    cfg = ott.DEFAULT_CONFIG
    mesh = make_mesh(1, 1, device_type="cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"world {dist.get_backend()} x {dist.get_world_size()}")
    print(f"phase 15 world: {dist.get_world_size()} rank, backend "
          f"{dist.get_backend()}, mesh {tuple(mesh.mesh.shape)} "
          f"{mesh.mesh_dim_names} on {torch.cuda.current_device()}")
    rx_clean, rx_cfo, data = head["rx_clean"], head["rx_cfo"], head["data"]
    kw = dict(n_blocks=head["nb"], guard_bands=True, modulation=MOD)
    want = {"clean": head["out_clean"], "CFO": head["out_cfo"]}
    one_each = launches(sync_align=1, eq_demod_pack=1)

    # the data-sharded batch decoders: decode_frame's bytes, its launches
    for name, x in (("clean", rx_clean), ("CFO", rx_cfo)):
        out, n = counted(lambda: decode_frame_sharded(x, mesh, **kw))
        check(n == one_each, f"decode_frame_sharded {name} launched {n}")
        check(torch.equal(out, want[name]), f"decode_frame_sharded {name}: "
              "bytes differ from decode_frame's")
        print(f"phase 15 decode_frame_sharded {name} ({BATCH} x {PAYLOAD} B "
              f"QAM64, T={x.shape[1]}): bytes equal decode_frame's; launches {n}")
    for label, planes, extra, n_want in (
            ("contiguous planes", head["planes_in"], {}, one_each),
            ("strided view", head["view"], {},
             launches(pin_rowmajor=1, sync_align=1, eq_demod_pack=1)),
            ("chunked", head["planes_in"], dict(align_impl="chunked"),
             launches(sync_align_chunked=1, eq_demod_pack=1))):
        out, n = counted(lambda: decode_frame_planar_sharded(planes, mesh,
                                                             **kw, **extra))
        check(n == n_want, f"decode_frame_planar_sharded {label} launched {n}")
        check(torch.equal(out, want["clean"]), f"decode_frame_planar_sharded "
              f"{label}: bytes differ from decode_frame's")
        print(f"phase 15 decode_frame_planar_sharded {label}: bytes equal "
              f"decode_frame's; launches {n}")

    # the time-sharded decode: sync_keys + K3, bytes decode_frame's
    ts_want = launches(sync_keys=1, planar_align=1)
    (ts_clean, ts_cfo), n_ts = counted(lambda: (
        decode_frame_timesharded(rx_clean, mesh, **kw),
        decode_frame_timesharded(rx_cfo, mesh, **kw)))
    check(n_ts == launches(sync_keys=2, planar_align=2),
          f"decode_frame_timesharded x2 launched {n_ts}")
    check(torch.equal(ts_clean, want["clean"]), "decode_frame_timesharded "
          "clean: bytes differ from decode_frame's")
    n = data.shape[1]
    both = ((ts_cfo[:, 16:16 + n] == data).all(1)
            & (want["CFO"][:, 16:16 + n] == data).all(1))
    check(int(both.sum()) >= 0.95 * BATCH and torch.equal(
        ts_cfo[both], want["CFO"][both]), f"decode_frame_timesharded CFO: "
          f"{int(both.sum())} rows exact on both paths")
    print(f"phase 15 decode_frame_timesharded: clean bytes equal "
          f"decode_frame's; CFO bytes equal on the {int(both.sum())}/{BATCH} "
          f"rows both decode exactly; launches {n_ts}")

    # sync_keys against its plain version at the headline's haloed shard
    t = rx_clean.shape[1]
    template = constants.locking_for(cfg)
    ext = torch.cat([rx_clean, rx_clean.new_zeros((BATCH, cfg.sym_len - 1))], 1)
    keys = sync_keys(ext, template, t)
    keys_ref = sync_keys_reference(ext, template, t)
    torch.cuda.synchronize()
    check(torch.equal(key_lag(keys), key_lag(keys_ref)),
          f"sync_keys: lags differ on {int((keys != keys_ref).sum())} rows")
    p, p_ref = key_power(keys), key_power(keys_ref)
    rel = float(((p - p_ref).abs() / p_ref).max())
    check(rel <= 1e-6, f"sync_keys: power differs by {rel:.3e} relative")
    keys_err = float((p - p_ref).abs().max())
    _, raw = sync_align(rx_clean, template, t - 80, planar=True)
    check(torch.equal(key_lag(keys), raw.long() + 1),
          "sync_keys' lags differ from sync_align's offsets + 1")
    print(f"phase 15 sync_keys at [{BATCH}, {ext.shape[1]}], lag_bound {t}: "
          f"lags equal plain's and sync_align's offsets + 1, power within "
          f"{rel:.3e} relative (max abs {keys_err:.3e})")

    # the time-sharded channel without noise: a float64 convolution on the
    # host, independent of the port's
    tx = pad_rows(ott.encode(data, guard_bands=True, modulation=MOD), t)
    conv = channel_timesharded_fn(mesh, snr=None, timing_error=False)(tx, 0)
    tx_h, conv_h = tx.cpu().numpy(), conv.cpu().numpy()
    taps_h = np.asarray(constants.CHANNEL_TAPS, np.float64)
    conv_err = max(float(np.abs(conv_h[r] - np.convolve(
        tx_h[r].astype(np.complex128), taps_h)[:t]).max()) for r in range(BATCH))
    check(conv_err <= 1e-5, f"time-sharded channel differs by {conv_err}")
    print(f"phase 15 channel_timesharded_fn (no noise, no CFO) on [{BATCH}, "
          f"{t}]: within {conv_err:.3e} of np.convolve in float64 on the host")

    # stream decoding at config 4 and the burst stream of phase 10
    s, rkw = streams["stream"], dict(streams["kw"])
    reg, n_reg = counted(lambda: decode_regular_sharded(s, mesh, **rkw))
    check(n_reg == launches(planar_align=1, sync_align=1, eq_demod_pack=1),
          f"decode_regular_sharded launched {n_reg}")
    single = ott.decode_regular(s, **rkw, resync=True)
    check(np.array_equal(reg[0], single[0]) and np.array_equal(
        reg[0], streams["want"]) and reg[1].all(),
          "decode_regular_sharded differs from decode_regular")
    _, n_sync = host_syncs(lambda: decode_regular_sharded(s, mesh, **rkw))
    check(n_sync == 1, f"decode_regular_sharded: {n_sync} synchronizing calls")
    print(f"phase 15 decode_regular_sharded at config 4 ({HAM_FRAMES} x "
          f"{HAM_BYTES} B Hamming, T={s.shape[0]}): equals decode_regular, 0 "
          f"byte errors; launches {n_reg}; synchronizing calls {n_sync}")
    bs, bkw = streams["burst"], streams["burst_kw"]
    found, n_burst = counted(lambda: decode_burst_sharded(bs, mesh, **bkw))
    check(n_burst == launches(planar_align=1, eq_demod_pack=1),
          f"decode_burst_sharded launched {n_burst}")
    ref = streams["burst_found"]
    check(len(found) == len(ref) == BURST_FRAMES and all(
        f[0] == r[0] and np.array_equal(f[1], r[1]) and f[2] == r[2]
        for f, r in zip(found, ref)), "decode_burst_sharded differs from "
          "decode_burst")
    print(f"phase 15 decode_burst_sharded on phase 10's {BURST_FRAMES} frames: "
          f"decode_burst's positions and bytes; launches {n_burst}")

    # the pipeline step at the headline width
    step = make_pipeline_step(mesh, payload_len=PAYLOAD, guard_bands=True,
                              modulation=MOD, snr=SNR, timing_error=True)
    pgen = torch.Generator().manual_seed(SEED)
    (decoded, errs), n_pipe = counted(lambda: step(data, pgen))
    check(n_pipe == ts_want, f"pipeline step launched {n_pipe}")
    check(int(errs[0]) == 0 and torch.equal(decoded[:, 16:16 + PAYLOAD], data),
          f"pipeline step: {int(errs[0])} bit errors")
    halo_mod.reset_counts()
    step(data, pgen)
    inv = halo_mod.counts()
    check(inv["all_gather"]["calls"] == 0 and inv["all_reduce"]["calls"] == 6,
          f"pipeline step collectives {inv}")
    print(f"phase 15 make_pipeline_step: {BATCH} x {PAYLOAD} B QAM64, SNR "
          f"{SNR}, timing error: 0 bit errors, payloads exact; launches "
          f"{n_pipe}; collectives per step {inv}")
    nccl_world(name_limit, data.cpu().numpy())

    # timing: each sharded call beside its single-device counterpart
    sgen = torch.Generator(dev).manual_seed(SEED)
    frame = rx_clean.shape[1]

    def single_step():
        tx_ = ott.encode(data, guard_bands=True, modulation=MOD)
        rx_ = pad_rows(ott.channel(tx_, snr=SNR, timing_error=True,
                                   generator=sgen), frame)
        out = ott.decode_frame(rx_, **kw)
        return bit_errors(out[:, 16:16 + PAYLOAD], data).sum()

    pairs = [
        ("decode_frame_sharded", lambda: decode_frame_sharded(rx_clean, mesh, **kw),
         "decode_frame", lambda: ott.decode_frame(rx_clean, **kw)),
        ("decode_frame_planar_sharded",
         lambda: decode_frame_planar_sharded(head["planes_in"], mesh, **kw),
         "decode_frame_planar",
         lambda: ott.decode_frame_planar(head["planes_in"], **kw)),
        ("decode_frame_timesharded",
         lambda: decode_frame_timesharded(rx_clean, mesh, **kw),
         "decode_frame", lambda: ott.decode_frame(rx_clean, **kw)),
        ("decode_regular_sharded",
         lambda: decode_regular_sharded(s, mesh, **rkw),
         "decode_regular resync",
         lambda: ott.decode_regular(s, **rkw, resync=True)),
        ("decode_burst_sharded", lambda: decode_burst_sharded(bs, mesh, **bkw),
         "decode_burst", lambda: ott.decode_burst(bs, **bkw)),
        ("pipeline step (T=38,160 a row)", lambda: step(data, pgen),
         "encode + channel + decode_frame + bit errors (T=19,120 a row)",
         single_step),
    ]
    print(f"phase 15 timing on {name_limit} (world of 1, NCCL; CUDA events, "
          f"median of {REPS}; device busy from torch.profiler):")
    for sharded_name, sharded_fn, single_name, single_fn in pairs:
        for label, fn in ((sharded_name, sharded_fn), (single_name, single_fn)):
            ms = time_ms(fn)
            dk = device_ms(fn)
            busy = sum(dk.values())
            print(f"  {ms:.4f} ms/step, busy {busy:.4f}, idle share "
                  f"{1 - busy / ms:.3f}  {label} on {name_limit}; top device "
                  "items:")
            for kname, kms in sorted(dk.items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {kms:.4f}  {kname[:100]}")
    # sync_keys' device time: CUDA events around back-to-back launches (its
    # first kernel opens a profiler session, where the profiler loses it),
    # with K1 beside it, timed the same way, as a yardstick
    keys_ms = launch_ms(lambda: sync_keys(ext, template, t))
    keys_plain_ms = launch_ms(lambda: sync_keys_reference(ext, template, t))
    k1_ms = launch_ms(lambda: sync_align(rx_clean, template, t - 80,
                                         planar=True))
    print(f"phase 15 sync_keys device time {keys_ms:.4f} ms/call, plain "
          f"{keys_plain_ms:.4f}, sync_align {k1_ms:.4f} (CUDA events around "
          f"{LAUNCH_REPS} back-to-back calls) on {name_limit}")
    r = ext.shape[0]
    flops = r * t * len(template) * 2 * 2 * (
        1 if not np.any(np.asarray(template).imag) else 2)
    keys_bound = bound(flops, ext.numel() * 8 + r * 8)
    cpu_worlds(name_limit)
    dist.destroy_process_group()
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": keys_ms, "plain_ms": keys_plain_ms, "bound": keys_bound,
            "launches": n_ts["sync_keys"], "max_abs_err": keys_err}


# phase 16: the port's bench, run as its users run it
BENCH_TIMEOUT_S = 600
BENCH_GATES = (("byte_errors_clean_batch",),
               ("planar_input", "byte_errors_clean_batch"))
BENCH_CONFIG_GATES = (
    ("configs", "hamming_streaming", "detail", "user_byte_errors"),
    ("configs", "hamming_streaming", "detail", "planar_input", "user_byte_errors"),
    *(("configs", "serving", "detail", mode, gate)
      for mode in ("d2h", "device_resident", "planar")
      for gate in ("payload_byte_errors", "image_errors", "rs_failures")))


def run_bench(*args: str) -> tuple[dict, float]:
    """``python -m ofdm_tpu_torch.bench`` with ``args`` in a subprocess from
    the checkout: (its last line, seconds).  Fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ofdm_tpu_torch.bench", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    check(proc.returncode == 0, f"bench {' '.join(args)} exited "
          f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0


def _at(d: dict, path: tuple):
    for key in path:
        d = d[key]
    return d


def check_bench(line: dict, name_limit: str, seed: int, full: bool) -> None:
    """The bench's line names this card, holds every gate at 0, times
    every step 100 times, and counts the kernels each step must launch."""
    name, limit = name_limit.rsplit(", ", 1)
    check(line["seed"] == seed and line["device"] == {
        "platform": "gpu", "name": name, "power_limit": limit,
        "count": torch.cuda.device_count()},
        f"bench device {line['device']}, want {name_limit!r}")
    d = line["detail"]
    check(sorted(d["configs"]) == (["hamming_streaming", "serving"] if full
                                   else []), f"bench configs {sorted(d['configs'])}")
    for path in BENCH_GATES + (BENCH_CONFIG_GATES if full else ()):
        check(_at(d, path) == 0, f"bench gate {'.'.join(path)} = {_at(d, path)}")
    k1_k2 = {"sync_align": 1, "eq_demod_pack": 1}
    want = {("launches",): k1_k2, ("planar_input", "launches"): k1_k2}
    timers = [("ms_per_step",), ("planar_input", "ms_per_step")]
    if full:
        ham = ("configs", "hamming_streaming", "detail")
        srv = ("configs", "serving", "detail")
        k3_k2 = {"planar_align": 1, "eq_demod_pack": 1}
        want |= {(*ham, "launches"): k3_k2,
                 (*ham, "planar_input", "launches"): k3_k2}
        want |= {(*srv, mode, "launches"): dict(k1_k2, planar_align=1)
                 for mode in ("d2h", "device_resident", "planar")}
        timers += [(*ham, "ms_per_step"), (*ham, "planar_input", "ms_per_step"),
                   (*srv, "d2h", "latency_ms"),
                   (*srv, "device_resident", "ms_per_step"),
                   (*srv, "planar", "latency_ms")]
    for path, n in want.items():
        check(_at(d, path) == n, f"bench {'.'.join(path)} = {_at(d, path)}, "
              f"want {n} per step")
    for path in timers:
        t = _at(d, path)
        check(t["n"] == 100 and "p90_ms" in t, f"bench {'.'.join(path)}: {t}")


def print_bench(line: dict, name_limit: str, sync_ms: dict) -> None:
    """The line's numbers, one thing a line; beside them the same steps
    timed by ``time_ms`` (synchronized after each step) in phases 5 and 11."""
    tag = f"phase 16 bench seed {line['seed']}"
    d = line["detail"]

    def steps(label: str, part: dict, sync: float | None = None) -> None:
        t = part["ms_per_step"]
        print(f"{tag} {label}: median {t['median_ms']:.4f} ms, p90 "
              f"{t['p90_ms']:.4f} (n {t['n']}), wall {t['wall_ms']:.4f} ms/step"
              + ("" if sync is None else f" (time_ms, synchronized: {sync:.4f})")
              + f", {part['samples_per_s']:.4e} samples/s, busy "
              f"{part['device_busy_ms']:.4f} ms, idle share "
              f"{part['idle_share']:.3f}, launches {part['launches']} on "
              f"{name_limit}; top device items:")
        for item in part["top_device_items"]:
            print(f"    {item['ms']:.4f}  {item['name'][:100]}")

    steps("headline decode_frame", d, sync_ms["decode_frame"])
    steps("headline decode_frame_planar", d["planar_input"])
    lat = d["blocking_latency_ms"]
    print(f"{tag} headline blocking latency median {lat['median_ms']:.4f} ms, "
          f"mean {lat['mean_ms']:.4f} (n {lat['n']}); peak memory "
          f"{d['peak_memory_bytes']} B; kernel build {d['kernel_build_s']:.2f} s")
    if not d["configs"]:
        return
    ham = d["configs"]["hamming_streaming"]["detail"]
    steps("config 4 presync complex", ham, sync_ms["complex presync"])
    steps("config 4 presync planar", ham["planar_input"],
          sync_ms["planar presync"])
    print(f"{tag} config 4 user GB/s {ham['user_GBps']:.4f} (complex), "
          f"{ham['planar_input']['user_GBps']:.4f} (planar); peak memory "
          f"{ham['peak_memory_bytes']} B")
    srv = d["configs"]["serving"]["detail"]
    for mode in ("d2h", "device_resident", "planar"):
        m = srv[mode]
        t = m.get("latency_ms") or m["ms_per_step"]
        what = "latency" if "latency_ms" in m else "step"
        print(f"{tag} serving {mode}: {m['ms_per_buffer']:.4f} ms/buffer, "
              f"{m['samples_per_s']:.4e} samples/s, "
              f"{m['image_frames_per_s']:.1f} image frames/s, {what} median "
              f"{t['median_ms']:.4f} p90 {t['p90_ms']:.4f} ms (n {t['n']}), "
              f"idle share {m['idle_share']:.3f}, launches {m['launches']} "
              f"({srv['buffers']} buffers of {srv['frames_per_buffer']} frames, "
              f"{srv['in_flight']} in flight) on {name_limit}")
    print(f"{tag} serving RS codec {srv['rs_codec']}")
    print(f"{tag} serving parts: fetch of the payload slice "
          f"({srv['payload_slice_bytes']} B) {srv['fetch_ms']:.4f} ms, RS "
          f"{srv['rs_ms']:.4f} ms, colorspace {srv['colorspace_ms']:.4f} ms a "
          f"buffer; serve step busy {srv['device_busy_ms']:.4f} ms; peak memory "
          f"{srv['peak_memory_bytes']} B; top device items:")
    for item in srv["top_device_items"]:
        print(f"    {item['ms']:.4f}  {item['name'][:100]}")


SERVE_KERNELS = {"planar_align": (streaming_mod, planar_align_reference),
                 "sync_align": (rx_mod, sync_align_reference),
                 "eq_demod_pack": (rx_mod, eq_demod_pack_reference)}


def serving_kernels(dev) -> dict:
    """K3, K1 and K2 against their plain versions on the very inputs the
    serve step hands each of them, on the bench's serving buffers (its seed
    0: BENCH_SRV_DISTINCT buffers of BENCH_SRV_FRAMES frames), each buffer
    complex [T] and planar [2, T]; every step's payload rows must be the RS
    code bytes that were sent.  Returns each kernel's largest difference."""
    bufs, pixels = serving.synth_buffers(BENCH_SRV_DISTINCT, BENCH_SRV_FRAMES,
                                         device=dev)
    worst = dict.fromkeys(SERVE_KERNELS, 0.0)
    calls = dict.fromkeys(SERVE_KERNELS, 0)
    shapes = {}

    def held(name, kernel, reference):
        def call(*args, **kw):
            got, ref = kernel(*args, **kw), reference(*args, **kw)
            got_t, ref_t = ((o if isinstance(o, tuple) else (o,))
                            for o in (got, ref))
            check(len(got_t) == len(ref_t), f"{name}: outputs differ in number")
            for g, r in zip(got_t, ref_t):
                check(g.shape == r.shape and g.dtype == r.dtype,
                      f"{name} at the bench's serving shape: {g.shape} "
                      f"{g.dtype}, plain {r.shape} {r.dtype}")
                worst[name] = max(worst[name],
                                  (g.double() - r.double()).abs().max().item())
            calls[name] += 1
            shapes[name] = [tuple(a.shape) for a in args
                            if isinstance(a, torch.Tensor)]
            return got
        return call

    with contextlib.ExitStack() as stack:
        for name, (module, reference) in SERVE_KERNELS.items():
            stack.enter_context(mock.patch.object(
                module, name, held(name, getattr(module, name), reference)))
        for b, buf in enumerate(bufs):
            sent = serving.encode_rows(pixels[b])
            for form, x in (("complex", buf),
                            ("planar", torch.stack([buf.real, buf.imag]))):
                raw = serving.serve_step(x, BENCH_SRV_FRAMES).cpu().numpy()
                errs = int((raw != sent).sum())
                check(errs == 0, f"bench serving buffer {b} {form}: {errs} "
                      "payload byte errors")
    want = 2 * len(bufs)
    check(calls == dict.fromkeys(SERVE_KERNELS, want),
          f"serve steps called {calls}, want {want} each")
    check(not any(worst.values()), f"at the bench's serving shape the "
          f"kernels differ from plain by {worst}")
    print(f"phase 16 K3, K1 and K2 on the inputs of {want} serve steps of the "
          f"bench's {len(bufs)} buffers of {BENCH_SRV_FRAMES} frames (complex "
          f"and planar; inputs {shapes}) identical to plain; every payload "
          "row the sent RS code bytes")
    return worst


def phase_bench(name_limit: str, sync_ms: dict) -> dict:
    """Phase 16: K3, K1 and K2 against plain at the bench's serving shape,
    then ``python -m ofdm_tpu_torch.bench`` at full size with seed 0, then
    the headline alone with seed 1.  Returns the kernels' differences."""
    worst = serving_kernels(torch.device("cuda", 0))
    for args, seed, full in ((("--seed", "0"), 0, True),
                             (("--seed", "1", "--only", "headline"), 1, False)):
        line, secs = run_bench(*args)
        check_bench(line, name_limit, seed, full)
        print_bench(line, name_limit, sync_ms)
        print(f"phase 16 bench {' '.join(args)}: exit 0 in {secs:.1f} s, every "
              f"gate 0, launches exact; its line: {json.dumps(line)}")
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")
    dev = torch.device("cuda", 0)
    set_full_fp32()
    native_s, native_flags = native.build()
    name_limit = card()
    print(f"phase 1 device: {name_limit}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; TF32 off through {tf32_flags()}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.2f} s for {len(libs)} sources, in "
          f"parallel, into {_build.BUILD_DIR}; native/ (RS codec, IQ loader) "
          f"{native_s:.2f} s, flags {' '.join(native_flags) or '(up to date)'}")
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
    (out_clean, out_cfo), n_default = counted(
        lambda: (ott.decode_frame(rx_clean, **kw), ott.decode_frame(rx_cfo, **kw)))
    check(n_default == launches(sync_align=2, eq_demod_pack=2),
          f"decode_frame x2 launched {n_default}, want 2 each of K1 and K2")
    check(tuple(out_clean.shape) == (BATCH, nb * 36),
          f"decode_frame shape {tuple(out_clean.shape)}")
    gates(out_clean, data, "decode_frame", cfo=False)
    good = gates(out_cfo, data, "decode_frame", cfo=True)
    print(f"phase 4 end to end: decode_frame on {BATCH} x {PAYLOAD} B QAM64 "
          f"SNR {SNR}, T={frame}: clean byte errors 0; CFO rows exact "
          f"{good}/{BATCH}; launches {n_default}")

    out_planar, n_planar = counted(lambda: ott.decode_frame_planar(planes_in, **kw))
    check(n_planar == launches(sync_align=1, eq_demod_pack=1),
          f"decode_frame_planar launched {n_planar}")
    check(torch.equal(out_planar, out_clean), "decode_frame_planar differs")
    payload0, n_decode = counted(
        lambda: ott.decode(rx_clean[0], guard_bands=True, modulation=MOD))
    check(n_decode == launches(sync_align=1, eq_demod_pack=1),
          f"decode launched {n_decode}")
    check(payload0.shape == (PAYLOAD,)
          and bool((torch.as_tensor(payload0, device=dev) == data[0]).all()),
          "decode: payload differs")
    print(f"phase 4 decode_frame_planar: bytes equal decode_frame's, launches "
          f"{n_planar}; decode: payload exact, launches {n_decode}")

    # K1 and K2 against their plain versions at the main path's own shapes
    need = (ott.DEFAULT_CONFIG.n_sync_chunks + nb) * 80
    tail_kw = dict(guard_bands=True, modulation=MOD, cfg=ott.DEFAULT_CONFIG)
    plain_kw = dict(n_data=48, n_pilots=4, modulation=MOD, cfg=ott.DEFAULT_CONFIG)
    for name, x in (("clean", rx_clean), ("CFO", rx_cfo)):
        planes, raw = sync_align(x, template, need, planar=True)
        planes_ref, raw_ref = sync_align_reference(x, template, need, planar=True)
        check(torch.equal(raw, raw_ref), f"{name} batch: sync offsets differ "
              f"from plain on {int((raw != raw_ref).sum())} rows")
        diff = (planes - planes_ref).abs().max().item()
        k1_err = max(k1_err, diff)
        check(diff == 0.0, f"{name} batch: sync_align window differs by {diff}")
        cp = planes.reshape(BATCH, 2, -1, 80)
        yr, yi, h_k, f_delta = rx_mod._matrix_front(
            cp[:, 0], cp[:, 1], guard_bands=True, cfg=ott.DEFAULT_CONFIG,
            cfo_estimator="coherent")
        k2 = rx_mod._tail(yr, yi, h_k, f_delta, **tail_kw)
        sel = list(rx_mod._selected_bins(True, ott.DEFAULT_CONFIG)[0])
        ti = (yr, yi, h_k[:, sel].contiguous(), f_delta)
        k2_ref = eq_demod_pack_reference(*ti, **plain_kw)
        k2_err = max(k2_err, (k2.int() - k2_ref.int()).abs().max().item())
        check(torch.equal(k2, k2_ref), f"{name} batch: eq_demod_pack differs "
              "from plain")
        print(f"phase 4 {name} batch at R={BATCH} T={x.shape[1]}: sync_align "
              "offsets and planes, eq_demod_pack bytes identical to plain")

    # phase 5: timing of the default route
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

    def time_kernels(phase, cases):
        for label, fn in cases:
            dk = device_ms(fn)
            dev_ms[label] = sum(dk.values())
            print(f"phase {phase} device time {label}: {dev_ms[label]:.4f} "
                  f"ms/call in {len(dk)} kernel names on {name_limit}")

    time_kernels(5, [
        ("sync_align", lambda: sync_align(rx_clean, template, need, planar=True)),
        ("sync_align plain", lambda: sync_align_reference(rx_clean, template,
                                                          need, planar=True)),
        ("eq_demod_pack", lambda: eq_demod_pack(*ti, **plain_kw)),
        ("eq_demod_pack plain", lambda: eq_demod_pack_reference(*ti, **plain_kw))])

    # phase 6: K3, K4 and K5 against their plain versions at the headline shape
    t = rx_clean.shape[1]
    offs = torch.randint(0, t - need + 1, (BATCH,), generator=gen, device=dev,
                         dtype=torch.int32)
    offs[0], offs[1] = 0, t - need
    k3_err = k4_err = k5_err = 0.0
    for name, x in (("complex", rx_clean), ("planar", planes_in)):
        for planar in (False, True):
            got = planar_align(x, offs, need, planar=planar)
            ref = planar_align_reference(x, offs, need, planar=planar)
            torch.cuda.synchronize()
            diff = (got - ref).abs().max().item()
            k3_err = max(k3_err, diff)
            check(torch.equal(got, ref), f"planar_align {name} in, planar="
                  f"{planar}: differs from plain by {diff}")
    print(f"phase 6 planar_align: R={BATCH} T={t} need={need}, offsets 0..T-need "
          "(0 and T-need included), complex and planar in and out: identical")
    # shared-stream mode: the rows flattened into one stream, every row
    # reading it; the last rows run past its end, the very last starts past it
    stream = rx_clean.reshape(-1)
    t_s = stream.shape[0]
    s_offs = (torch.arange(BATCH, device=dev) * t
              + torch.randint(0, 200, (BATCH,), generator=gen, device=dev))
    s_offs[-3:] = torch.tensor([t_s - need // 2, t_s - 1, t_s + 5], device=dev)
    for name, x in (("complex [T]", stream),
                    ("planar [2, T]", torch.stack([stream.real, stream.imag])),
                    ("strided planar view", torch.view_as_real(stream).t())):
        for planar in (False, True):
            got = planar_align(x, s_offs, need, planar=planar)
            ref = planar_align_reference(x, s_offs, need, planar=planar)
            torch.cuda.synchronize()
            diff = (got - ref).abs().max().item()
            k3_err = max(k3_err, diff)
            check(torch.equal(got, ref), f"planar_align shared {name}, planar="
                  f"{planar}: differs from plain by {diff}")
    print(f"phase 6 planar_align shared stream: T={t_s}, {BATCH} rows of {need}, "
          "3 of them past the end (read as 0), complex, planar and strided "
          "planar stream, complex and planar out: identical")
    n_chunks = ott.DEFAULT_CONFIG.n_sync_chunks + nb
    for name, x in (("complex clean", rx_clean), ("planar clean", planes_in),
                    ("complex CFO", rx_cfo)):
        (gr, gi), slots, m_per = sync_align_chunked(x, template, n_chunks=n_chunks)
        (rr, ri), _, _ = sync_align_chunked_reference(x, template,
                                                      n_chunks=n_chunks)
        torch.cuda.synchronize()
        check(slots >= n_chunks, f"chunk geometry {slots} slots, {m_per}")
        diff = max((gr - rr).abs().max().item(), (gi - ri).abs().max().item())
        k4_err = max(k4_err, diff)
        check(torch.equal(gr, rr) and torch.equal(gi, ri),
              f"sync_align_chunked {name}: differs from plain by {diff}")
    print(f"phase 6 sync_align_chunked: R={BATCH} T={t} n_chunks={n_chunks} -> "
          f"2 x [{BATCH}, {slots}, 128], complex and planar in, every lane "
          "identical to plain")
    view = torch.view_as_real(rx_clean).transpose(1, 2)
    got = pin_rowmajor(view)
    ref = pin_rowmajor_reference(view)
    torch.cuda.synchronize()
    k5_err = (got - ref).abs().max().item()
    check(torch.equal(got, ref) and got.is_contiguous(),
          f"pin_rowmajor differs from plain by {k5_err}")
    print(f"phase 6 pin_rowmajor: view_as_real(rx).transpose(1, 2) "
          f"{tuple(view.shape)} strides {view.stride()} -> row-major, identical")

    # phase 7: the other routes end to end, each with exact launch counts
    routes = {"default (K1 + K2)": lambda: ott.decode_frame(rx_clean, **kw)}
    bf = dict(kw, sync_dtype=torch.bfloat16)
    (b_clean, b_cfo), n_bf = counted(
        lambda: (ott.decode_frame(rx_clean, **bf), ott.decode_frame(rx_cfo, **bf)))
    check(n_bf == launches(planar_align=2, eq_demod_pack=2),
          f"decode_frame(sync_dtype=bfloat16) x2 launched {n_bf}")
    gates(b_clean, data, "bf16 sync", cfo=False)
    good = gates(b_cfo, data, "bf16 sync", cfo=True)
    routes["sync_dtype=bfloat16 (K3 + K2)"] = (lambda: ott.decode_frame(rx_clean, **bf))
    print(f"phase 7 decode_frame sync_dtype=bfloat16: clean byte errors 0; CFO "
          f"rows exact {good}/{BATCH}; launches {n_bf}")
    for sd in ("fft", "conv"):
        out_sd, n_sd = counted(lambda: ott.decode_frame(rx_clean, sync_dtype=sd,
                                                        **kw))
        check(n_sd == launches(planar_align=1, eq_demod_pack=1),
              f"decode_frame(sync_dtype={sd!r}) launched {n_sd}")
        gates(out_sd, data, f"{sd} sync", cfo=False)
        print(f"phase 7 decode_frame sync_dtype={sd!r}: clean byte errors 0; "
              f"launches {n_sd}")

    ch = dict(kw, align_impl="chunked")
    (c_clean, c_cfo), n_ch = counted(
        lambda: (ott.decode_frame(rx_clean, **ch), ott.decode_frame(rx_cfo, **ch)))
    check(n_ch == launches(sync_align_chunked=2, eq_demod_pack=2),
          f"decode_frame(align_impl='chunked') x2 launched {n_ch}")
    gates(c_clean, data, "chunked", cfo=False)
    good = gates(c_cfo, data, "chunked", cfo=True)
    c_planar, n_chp = counted(lambda: ott.decode_frame_planar(planes_in, **ch))
    check(n_chp == launches(sync_align_chunked=1, eq_demod_pack=1),
          f"decode_frame_planar(align_impl='chunked') launched {n_chp}")
    check(torch.equal(c_planar, c_clean), "chunked: planar input differs")
    routes["align_impl=chunked (K4 + K2)"] = (lambda: ott.decode_frame(rx_clean, **ch))
    print(f"phase 7 decode_frame align_impl=chunked: clean byte errors 0; CFO "
          f"rows exact {good}/{BATCH}; launches {n_ch}; decode_frame_planar "
          f"chunked equal, launches {n_chp}")

    out_view, n_view = counted(lambda: ott.decode_frame_planar(view, **kw))
    check(n_view == launches(pin_rowmajor=1, sync_align=1, eq_demod_pack=1),
          f"decode_frame_planar on the strided view launched {n_view}")
    check(torch.equal(out_view, out_clean), "strided planar view differs")
    routes["decode_frame_planar, strided view (K5 + K1 + K2)"] = (
        lambda: ott.decode_frame_planar(view, **kw))
    print(f"phase 7 decode_frame_planar on the strided view: bytes equal "
          f"decode_frame's; launches {n_view}")

    cfg160 = ott.FrameConfig(n_fft=128, cp_len=32, n_training=3, n_preamble=2,
                             locking_seed=7)
    nb160 = ott.n_data_blocks(PAYLOAD, MOD, True, cfg160)
    frame160 = cfg160.sync_len + cfg160.sym_len + nb160 * cfg160.sym_len
    rx160 = pad_rows(ott.channel(ott.encode(data, guard_bands=True,
                                            modulation=MOD, cfg=cfg160),
                                 snr=SNR, generator=gen), frame160)
    rx160_cfo = with_cfo(rx160, gen, cfg160.sym_len)
    kw160 = dict(kw, n_blocks=nb160, cfg=cfg160)
    (g_clean, g_cfo), n_160 = counted(
        lambda: (ott.decode_frame(rx160, **kw160),
                 ott.decode_frame(rx160_cfo, **kw160)))
    check(n_160 == launches(planar_align=2, eq_demod_pack=2),
          f"decode_frame 160-tap x2 launched {n_160}")
    gates(g_clean, data, "160-tap decode_frame", cfo=False)
    good = gates(g_cfo, data, "160-tap decode_frame", cfo=True)
    pay160, n_d160 = counted(lambda: ott.decode(rx160[0], guard_bands=True,
                                                modulation=MOD, cfg=cfg160))
    check(n_d160 == launches(planar_align=1, eq_demod_pack=1),
          f"decode 160-tap launched {n_d160}")
    check(pay160.shape == (PAYLOAD,)
          and bool((torch.as_tensor(pay160, device=dev) == data[0]).all()),
          "decode 160-tap: payload differs")
    routes["160-tap geometry (K3 + K2)"] = (lambda: ott.decode_frame(rx160, **kw160))
    print(f"phase 7 160-tap geometry (n_fft 128, sym 160, {nb160} blocks, "
          f"T={frame160}): decode_frame clean byte errors 0, CFO rows exact "
          f"{good}/{BATCH}, launches {n_160}; decode one row: payload exact, "
          f"launches {n_d160}")

    # phase 8: per-route step time, and K3, K4, K5 against their plain versions
    # timed again here beside the default route: the profiler sessions above
    # may leave the host slower than it was in phase 5
    print(f"phase 8 decode_frame per route on {name_limit} ({BATCH} rows, "
          f"QAM64, T={t} (160-tap: {frame160}), CUDA events median of {REPS}; "
          "device busy from torch.profiler):")
    for label, fn in routes.items():
        ms = time_ms(fn)
        dk = device_ms(fn)
        b = sum(dk.values())
        print(f"  {ms:.4f} ms/step, busy {b:.4f}, idle share {1 - b / ms:.3f}  "
              f"{label}; top kernels:")
        for kname, kms in sorted(dk.items(), key=lambda kv: -kv[1])[:4]:
            print(f"    {kms:.4f}  {kname[:100]}")
    time_kernels(8, [
        ("planar_align", lambda: planar_align(rx_clean, offs, need, planar=True)),
        ("planar_align plain", lambda: planar_align_reference(rx_clean, offs,
                                                              need, planar=True)),
        ("sync_align_chunked", lambda: sync_align_chunked(rx_clean, template,
                                                          n_chunks=n_chunks)),
        ("sync_align_chunked plain", lambda: sync_align_chunked_reference(
            rx_clean, template, n_chunks=n_chunks)),
        ("pin_rowmajor", lambda: pin_rowmajor(view)),
        ("pin_rowmajor plain", lambda: pin_rowmajor_reference(view))])

    # the one PyTorch call that computes each kernel's function, where one
    # exists: K3's windows as one advanced-indexing gather of the complex
    # rows' float view into [R, 2, need] (the index built outside the
    # timed call), K5's copy as x.contiguous()
    g_rows = torch.arange(BATCH, device=dev)[:, None, None]
    g_idx = (offs[:, None].long() + torch.arange(need, device=dev))[:, None, :]
    g_plane = torch.arange(2, device=dev)[None, :, None]
    rx_view = torch.view_as_real(rx_clean)
    check(torch.equal(rx_view[g_rows, g_idx, g_plane],
                      planar_align(rx_clean, offs, need, planar=True)),
          "the indexing call differs from planar_align")
    time_kernels(8, [("planar_align library",
                      lambda: rx_view[g_rows, g_idx, g_plane]),
                     ("pin_rowmajor library", lambda: view.contiguous())])

    # bounds from this run's shapes: each input read once, each output
    # written once; the correlation's FMAs (2 flops, 2 planes, 2 per
    # complex tap) over the fp32 rate without tensor cores
    r = rx_clean.shape[0]
    corr_flops = r * t * len(template) * 2 * 2 * (
        1 if not np.any(np.asarray(template).imag) else 2)
    cplx_in = r * t * 8
    # K2: the planes at the selected bins, h, f_delta in; the bytes out;
    # ~12 flops per bin (rotate, equalize) and ~10 per data bin (pilot
    # phase, decision)
    yr_t, _, h_t, fd_t = ti
    n_sym = yr_t.shape[0] * yr_t.shape[1] * plain_kw["n_data"]
    k2_bytes = (2 * yr_t.numel() * 4 + h_t.numel() * 8 + fd_t.numel() * 4
                + n_sym * BITS_PER_SYMBOL[MOD] // 8)
    k2_flops = yr_t.numel() * 12 + n_sym * 10
    bounds = {
        "sync_align": bound(corr_flops, cplx_in + r * need * 8 + r * 4),
        "eq_demod_pack": bound(k2_flops, k2_bytes),
        "planar_align": bound(0, 2 * r * need * 8 + r * 4),
        "sync_align_chunked": bound(corr_flops, cplx_in + 2 * r * slots * 128 * 4),
        "pin_rowmajor": bound(0, 2 * view.numel() * 4),
    }

    def entry(name, source, replaces, n, err):
        bound_ms, bound_by = bounds[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": dev_ms[name], "plain_ms": dev_ms[f"{name} plain"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": dev_ms.get(f"{name} library")}

    kernels = [
        entry("sync_align", "ofdm_tpu_torch/csrc/sync_align.cu",
              "ofdm_tpu/kernels/align_pallas.py:126",
              n_default["sync_align"], k1_err),
        entry("eq_demod_pack", "ofdm_tpu_torch/csrc/eq_demod_pack.cu",
              "ofdm_tpu/kernels/demod_pallas.py:166",
              n_default["eq_demod_pack"], k2_err),
        entry("planar_align", "ofdm_tpu_torch/csrc/sync_align.cu",
              "ofdm_tpu/kernels/align_pallas.py:51",
              n_bf["planar_align"], k3_err),
        entry("sync_align_chunked", "ofdm_tpu_torch/csrc/sync_align.cu",
              "ofdm_tpu/kernels/chain_pallas.py:139",
              n_ch["sync_align_chunked"], k4_err),
        entry("pin_rowmajor", "ofdm_tpu_torch/csrc/pin_rowmajor.cu",
              "ofdm_tpu/kernels/align_pallas.py:237",
              n_view["pin_rowmajor"], k5_err),
    ]
    streams = phase_streaming(gen, dev, name_limit)
    geometry = (serving.PAYLOAD_LEN, serving.N_BLOCKS, serving.FLEN,
                serving.buffer_len())
    check(geometry == (765, 22, 2560, 1_996_960), f"config 5 geometry {geometry}")
    phase_serving(dev, name_limit, serving.N_FRAMES)
    phase_captures(dev, n_decode)
    phase_apps(dev, name_limit)
    head = dict(rx_clean=rx_clean, rx_cfo=rx_cfo, data=data, nb=nb,
                out_clean=out_clean, out_cfo=out_cfo, planes_in=planes_in,
                view=view)
    keys = phase_parallel(dev, name_limit, head, streams)
    bench_err = phase_bench(name_limit, {"decode_frame": step_ms,
                                         **streams["step_ms"]})
    for e in kernels:
        e["max_abs_err"] = max(e["max_abs_err"], bench_err.get(e["name"], 0.0))
    bounds["sync_keys"] = keys["bound"]
    dev_ms["sync_keys"], dev_ms["sync_keys plain"] = keys["ms"], keys["plain_ms"]
    kernels.append(entry("sync_keys", "ofdm_tpu_torch/csrc/sync_align.cu",
                         "ofdm_tpu/parallel/timeshard.py:135-147",
                         keys["launches"], keys["max_abs_err"]))
    for e in kernels:
        print(f"kernel {e['name']}: {e['ms']:.4f} ms/call, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), roofline share "
              f"{e['bound_ms'] / e['ms']:.3f}; plain {e['plain_ms']:.4f}"
              + ("" if e["library_ms"] is None
                 else f"; library {e['library_ms']:.4f}") + f" on {name_limit}")
    print(name_limit)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
