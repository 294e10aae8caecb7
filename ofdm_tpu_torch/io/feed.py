"""Streaming sample-feed harness — the USRP/UHD replacement (port of
ofdm_tpu/io/feed.py; ``SampleFeed``, ``file_replay`` and
``synthetic_captures`` are its copies).

Rebuilds the reference's live capture architecture (examples/jetson_rx.rs:24-57)
without radio hardware: a producer thread reads IQ capture buffers (from
files, a generator, or a synthesizer) and hands them to the consumer over a
bounded queue with depth-1 backpressure, exactly like the reference's
``sync_channel(1)``.  The consumer overlaps host->device upload of buffer
N+1 with decode of buffer N (double buffering): on CUDA through a
``core.transfer.Uploader``, whose copies run on a copy stream of their own.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np

from ..core.transfer import Uploader


class SampleFeed:
    """Producer thread + bounded queue, reference-style backpressure."""

    _SENTINEL = object()

    def __init__(self, source: Iterable[np.ndarray], depth: int = 1):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._source = source
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._exc: BaseException | None = None

    def _run(self):
        try:
            for buf in self._source:
                self._queue.put(buf)
        except BaseException as e:  # surfaced to the consumer
            self._exc = e
        finally:
            self._queue.put(self._SENTINEL)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._thread.join(timeout=5.0)
        return False

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                if self._exc is not None:
                    raise self._exc
                return
            yield item


def file_replay(paths, dtype=np.complex64, loop: int = 1):
    """Generator replaying fc32 .dat capture files (the lab3c/jetson path)."""
    from .iqfile import read_iq

    for _ in range(loop):
        for p in paths:
            yield read_iq(p, dtype=dtype)


def synthetic_captures(n_buffers: int, frames_per_buffer: int,
                       make_frame: Callable[[int], np.ndarray],
                       buffer_len: int, seed: int = 0):
    """Synthesize capture buffers containing frames at random offsets inside
    noise — the software stand-in for a 2M-sample USRP buffer."""
    rng = np.random.default_rng(seed)
    for b in range(n_buffers):
        buf = (0.002 * (rng.standard_normal(buffer_len)
                        + 1j * rng.standard_normal(buffer_len))).astype(np.complex64)
        for f in range(frames_per_buffer):
            frame = np.asarray(make_frame(b * frames_per_buffer + f))
            start = rng.integers(0, max(1, buffer_len - frame.size))
            buf[start:start + frame.size] += frame.astype(np.complex64)
        yield buf


def double_buffered(feed: Iterable, upload: Callable[[np.ndarray], object]):
    """Overlap upload of buffer N+1 with consumption of buffer N.

    Yields device buffers.  ``upload`` is a function of one host buffer,
    typically ``ofdm_tpu_torch.core.transfer.to_device``, or an
    ``Uploader``: then each copy is only started (on the uploader's copy
    stream) when the buffer is taken from the feed, and the current stream
    waits for it when the buffer is yielded, so the copy of buffer N+1 runs
    while buffer N decodes.
    """
    if isinstance(upload, Uploader):
        start, finish = upload.start, (lambda u: u.wait())
    else:
        start, finish = upload, (lambda b: b)
    it = iter(feed)
    try:
        pending = start(next(it))
    except StopIteration:
        return
    for nxt in it:
        nxt_dev = start(nxt)      # starts async H2D while caller works
        yield finish(pending)
        pending = nxt_dev
    yield finish(pending)
