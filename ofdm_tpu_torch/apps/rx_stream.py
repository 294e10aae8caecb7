"""rx_stream: live streaming receiver (port of ofdm_tpu/apps/rx_stream.py,
which rebuilds examples/jetson_rx.rs:24-116).

A capture thread replays IQ buffers (files or synthesized frames) through the
bounded feed — the software stand-in for the USRP B210 — while the main loop
uploads each buffer through pinned double buffering, decodes it on the card
and renders recovered image frames.  Decode failures skip the buffer and
keep streaming, like the reference's live loop (examples/jetson_rx.rs:87-90).

Without ``--image-bytes`` the image is a ``--width`` x ``--height`` id image
made from a fixed seed.  ``--device`` (default cuda) picks where buffers are
decoded; on CUDA the app turns TF32 off, as the decoder requires.

    python -m ofdm_tpu_torch.apps.rx_stream --buffers 4 --timing
"""

from __future__ import annotations

import argparse
import pathlib
import time

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import (add_device_arg, load_image,
                                        resolve_device)
from ofdm_tpu_torch.core.corpus import decipher_transmission_colorspace
from ofdm_tpu_torch.core.transfer import Uploader, to_host
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io.feed import (SampleFeed, double_buffered, file_replay,
                                    synthetic_captures)
from ofdm_tpu_torch.obs.logging import set_up_logging
from ofdm_tpu_torch.packets.colors import id_to_rgb
from ofdm_tpu_torch.phy.streaming import (coded_len, decode_burst,
                                          decode_continuous)


class _Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--files", nargs="*", default=None,
                   help="IQ .dat files to replay (default: synthesize)")
    p.add_argument("--buffers", type=int, default=8)
    p.add_argument("--buffer-len", type=int, default=65536)
    p.add_argument("--image-bytes", default=None,
                   help="colorspace .bytes image to stream when synthesizing "
                        "(default: a --width x --height id image from a seed)")
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--out-dir", default=None, help="save recovered frames as PNGs")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ott.Modulation])
    p.add_argument("--continuous", action="store_true",
                   help="scan each buffer for multiple frames (multi-frame demod)")
    p.add_argument("--scan-loop", action="store_true",
                   help="with --continuous: use the host-driven scan loop "
                        "(decode_continuous) instead of the batched burst decoder")
    p.add_argument("--fec", default="rs", choices=["rs", "hamming", "none"],
                   help="FEC codec for --continuous mode payloads")
    p.add_argument("--timing", action="store_true",
                   help="log per-buffer wall-clock decode time (the live-path "
                        "latency metric)")
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("rx_stream")
    mod = ott.Modulation(args.modulation)
    dev = resolve_device(args.device)
    image = load_image(args.image_bytes, args.width, args.height)

    if args.files:
        source = file_replay(args.files)
    else:
        coded = rs.encode_stream(image)
        # Encode on the device BEFORE the capture thread starts: the producer
        # thread stays host-only.
        frame = to_host(ott.encode(coded, guard_bands=True, modulation=mod,
                                   device=dev))
        source = synthetic_captures(args.buffers, 1, lambda i: frame,
                                    args.buffer_len)
    upload = Uploader(dev)

    if args.continuous:
        raw_len = image.size
        fec = None if args.fec == "none" else args.fec
        payload_len = coded_len(raw_len, fec)
        n_frames = 0
        with SampleFeed(source) as feed:
            for i, buf in enumerate(double_buffered(feed, upload)):
                # burst mode: one batched window scan and one batched decode
                # per buffer instead of one host sync per window
                with _Timer() as tm:
                    if args.scan_loop:
                        found = list(decode_continuous(
                            buf, payload_len=payload_len, modulation=mod,
                            fec=fec, data_len=raw_len))
                    else:
                        found = decode_burst(buf, payload_len=payload_len,
                                             modulation=mod, fec=fec,
                                             data_len=raw_len)
                if args.timing:
                    log.info("buffer %d: decode %.2f ms (%d samples)", i,
                             tm.ms, buf.shape[-1])
                for pos, payload, ok in found:
                    if not ok:
                        log.warning("buffer %d @%d: FEC failure", i, pos)
                        continue
                    n_frames += 1
                    log.info("buffer %d: frame @%d ok (%d bytes)", i, pos,
                             payload.size)
        log.info("continuous stream done: %d frames", n_frames)
        return 0 if n_frames else 1

    n_ok = n_skip = 0
    with SampleFeed(source) as feed:
        for i, buf in enumerate(double_buffered(feed, upload)):
            try:
                with _Timer() as tm:
                    out = ott.decode(buf, guard_bands=True, modulation=mod)
                if args.timing:
                    log.info("buffer %d: decode %.2f ms (%d samples)", i,
                             tm.ms, buf.shape[-1])
            except ott.DecodeError as e:
                log.warning("buffer %d: decode failed (%s), skipping", i, e)
                n_skip += 1
                continue
            pixels = decipher_transmission_colorspace(out, ecc=True)
            if pixels is None:
                log.warning("buffer %d: FEC uncorrectable, skipping", i)
                n_skip += 1
                continue
            expected = args.width * args.height
            if pixels.size < expected:
                log.warning("buffer %d: unexpected payload size %d, skipping",
                            i, pixels.size)
                n_skip += 1
                continue
            n_ok += 1
            log.info("buffer %d: frame recovered (%d px)", i, expected)
            if args.out_dir:
                from PIL import Image
                outp = pathlib.Path(args.out_dir)
                outp.mkdir(parents=True, exist_ok=True)
                rgb = id_to_rgb(rs.decode_stream(out)[0][: expected]).reshape(
                    args.height, args.width, 3)
                Image.fromarray(rgb, "RGB").save(outp / f"frame_{i:03d}.png")

    log.info("stream done: %d frames ok, %d skipped", n_ok, n_skip)
    return 0 if n_ok > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
