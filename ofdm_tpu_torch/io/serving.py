"""The serving composition of config 5: capture buffers in, checked image
frames out (port of tools/exp_serving.py and bench.py's ``bench_serving``).

The live receiver of the reference (examples/jetson_rx.rs:24-116): a
capture thread fills ~2M-sample buffers (``io.feed.SampleFeed``), uploads
are double-buffered (``io.feed.double_buffered`` with a
``core.transfer.Uploader``), one sync + extract + decode runs per buffer
with several buffers in flight, and on the host one batched RS(255,223)
decode and the xterm-256 colorspace turn each buffer's bytes into image
frames.

- ``serve_step``: one buffer, complex [T] or planar f32 [2, T], and no host
  sync: the global sync (``phy.streaming._first_sync``, clamped at 0),
  then ``_extract_and_decode`` (the ``planar_align`` kernel K3 cuts every
  frame from the stream, ``sync_align`` K1 resyncs each row within one
  symbol, ``eq_demod_pack`` K2 demodulates), then the device slice of the
  RS payload.
- ``serve``: the loop.  Each step's payload is fetched asynchronously on
  the calling thread (every CUDA enqueue stays there); a pool of 2 worker
  threads waits for each fetch and runs the host tail (``host_tail``); at
  most ``in_flight`` buffers are pending.  It yields one ``Served`` per
  buffer, in order.
- The constants hold config 5's sizes; ``synth_buffers`` makes its
  buffers from a seed.

The originals mix a carry scalar from each buffer's bytes into the next
dispatch so that a TPU runtime's result cache cannot skip work; eager
PyTorch has no such cache, so there is no carry here, and the bytes of
every buffer are checked instead (``chip_smoke.py``).
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..core import device as device_mod
from ..core.transfer import fetch_async
from ..fec import reed_solomon as rs
from ..packets.colors import id_to_rgb
from ..packets.header import HEADER_LEN
from ..phy import streaming
from ..phy.channel import channel
from ..phy.modulation import Modulation
from ..phy.tx import encode, n_data_blocks


# Config 5 (tools/exp_serving.py:52-58, 73-78): each frame carries one
# 24 x 24 id image, RS-coded (576 user bytes -> 765), QAM64 with guard
# bands, 2,560 samples; frames sit back to back, so the spacing is the frame
# length.
WIDTH = HEIGHT = 24
USER_BYTES = WIDTH * HEIGHT
MODULATION = Modulation.QAM64
CFG = DEFAULT_CONFIG
PAYLOAD_LEN = (USER_BYTES // rs.K + 1) * rs.N
N_BLOCKS = n_data_blocks(PAYLOAD_LEN, MODULATION, True, CFG)
FLEN = CFG.sync_len + N_BLOCKS * CFG.sym_len
N_FRAMES = 780
SNR = 45.0
SEED = 5                 # tools/exp_serving.py:83
WORKERS = 2


def buffer_len(n_frames: int = N_FRAMES) -> int:
    """Samples in a buffer of ``n_frames`` frames and two spare symbols
    (config 5: 780 x 2,560 + 160 = 1,996,960)."""
    return n_frames * FLEN + 2 * CFG.sym_len


def serve_step(stream: torch.Tensor, n_frames: int = N_FRAMES) -> torch.Tensor:
    """Decode one buffer on its device, without waiting for it: uint8
    [n_frames, PAYLOAD_LEN], the RS code bytes of every frame."""
    s, planar = streaming._stream(stream, None)
    sync = streaming._first_sync_planar if planar else streaming._first_sync
    first = sync(s, spacing=FLEN, cfg=CFG).clamp(min=0)
    out = streaming._extract_and_decode(
        s, first, n_frames=n_frames, spacing=FLEN, nb=N_BLOCKS, flen=FLEN,
        guard_bands=True, modulation=MODULATION, cfg=CFG)
    return out[:, HEADER_LEN:HEADER_LEN + PAYLOAD_LEN]


@dataclass
class Served:
    """One buffer through the host tail."""

    index: int
    raw: np.ndarray          # uint8 [n_frames, PAYLOAD_LEN]: the RS code bytes
    pixels: np.ndarray       # uint8 [n_frames, USER_BYTES]: each frame's ids
    rgb: np.ndarray          # uint8 [n_frames, HEIGHT, WIDTH, 3]
    ok: np.ndarray           # bool [n_frames]: RS decoded every block
    latency_s: float         # from the step's enqueue to the tail's end
    rs_s: float              # the batched RS decode
    colors_s: float          # the colorspace


def host_tail(raw: np.ndarray):
    """(pixels, rgb, ok, RS seconds, colorspace seconds) of one buffer's
    payload rows: one batched RS(255,223) decode, then the xterm-256
    colorspace (bench.py:454-457)."""
    t0 = time.perf_counter()
    pixels, ok = rs.decode_payload_rows(raw, USER_BYTES)
    t1 = time.perf_counter()
    rgb = id_to_rgb(pixels.reshape(-1)).reshape(raw.shape[0], HEIGHT, WIDTH, 3)
    return pixels, rgb, ok, t1 - t0, time.perf_counter() - t1


def _finish(index: int, fetch, t_enqueue: float) -> Served:
    raw = fetch.result()
    pixels, rgb, ok, rs_s, colors_s = host_tail(raw)
    return Served(index, raw, pixels, rgb, ok, time.perf_counter() - t_enqueue,
                  rs_s, colors_s)


def serve(buffers: Iterable[torch.Tensor], n_frames: int = N_FRAMES, *,
          in_flight: int = 4) -> Iterator[Served]:
    """Serve device buffers of ``n_frames`` frames (complex [T] or planar
    [2, T]; a ``double_buffered`` feed or buffers already on the device),
    keeping at most ``in_flight`` of them pending; yields each buffer's
    ``Served`` in order."""
    if in_flight < 1:
        raise ValueError(f"in_flight must be >= 1, got {in_flight}")
    pending: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        for i, buf in enumerate(buffers):
            t0 = time.perf_counter()
            fetch = fetch_async(serve_step(buf, n_frames))
            pending.append(pool.submit(_finish, i, fetch, t0))
            while len(pending) > in_flight:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def encode_rows(pixels: np.ndarray) -> np.ndarray:
    """RS-code each row of uint8 [R, L] as ``rs.encode_stream`` does (the
    reference's framing), in one batched codec call."""
    r, n = pixels.shape
    n_blk = n // rs.K + 1
    padded = np.zeros((r, n_blk * rs.K), np.uint8)
    padded[:, :n] = pixels
    return rs.encode_blocks(padded.reshape(r * n_blk, rs.K)).reshape(
        r, n_blk * rs.N)


def _channel_seed(seed: int, device: torch.device) -> int:
    """The first generator seed from ``seed`` on whose first draw the
    channel's CFO lies below 0.8 pi / 80, inside the preamble estimator's
    range (the channel draws it uniformly in [0, pi / 80))."""
    return next(k for k in range(seed, seed + 1000) if float(torch.rand(
        (1,), generator=torch.Generator(device).manual_seed(k),
        device=device)[0]) < 0.8)


def synth_buffers(n_distinct: int, n_frames: int = N_FRAMES, *,
                  seed_offset: int = 0, device=None):
    """(complex64 buffers [buffer_len(n_frames)] on ``device``, their pixels
    uint8 [n_distinct, n_frames, USER_BYTES]), as tools/exp_serving.py:82-97
    makes them: random id images, RS-coded, encoded, back to back, through
    the channel at SNR 45; odd buffers add a CFO.  Made on the device:
    numpy draws the pixels from ``SEED + seed_offset`` (offset 0 draws
    tools/exp_serving.py's and bench.py:422-424's), and buffer b's channel
    generator starts from 1000 (b + 1) + 1,000,000 seed_offset; the
    channel's draws differ from the JAX package's."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(SEED + seed_offset)
    pixels = rng.integers(0, 256, (n_distinct, n_frames, USER_BYTES),
                          dtype=np.uint8)
    bufs = []
    for b in range(n_distinct):
        coded = torch.from_numpy(encode_rows(pixels[b])).to(dev)
        tx = encode(coded, guard_bands=True, modulation=MODULATION,
                    cfg=CFG).reshape(-1)
        t = buffer_len(n_frames)
        stream = torch.cat([tx, tx.new_zeros(t - tx.shape[0])])
        cfo = b % 2 == 1
        k = 1000 * (b + 1) + 1_000_000 * seed_offset
        k = _channel_seed(k, dev) if cfo else k
        rx = channel(stream, snr=SNR, timing_error=cfo,
                     generator=torch.Generator(dev).manual_seed(k))
        bufs.append(rx[:t])
    return bufs, pixels
