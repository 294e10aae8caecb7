"""lab3c_image: file-based tx/rx of the colorspace image payload (port of
ofdm_tpu/apps/lab3c_image.py, which rebuilds examples/lab3c_image.rs):
``--transmit`` writes the RS-coded image frame as an fc32 IQ file;
``--receive`` decodes a (possibly captured) file, writes the recovered
frame's colour ids (``--out-bytes``) and renders it as a PNG (``--out``,
needs Pillow).  Without ``--image`` the image is the seeded id image."""

from __future__ import annotations

import argparse
import pathlib

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import (add_device_arg, load_image,
                                        resolve_device)
from ofdm_tpu_torch.core.transfer import to_host
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io.iqfile import read_iq, write_iq
from ofdm_tpu_torch.obs.logging import set_up_logging
from ofdm_tpu_torch.packets.colors import id_to_rgb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--transmit", metavar="PATH")
    g.add_argument("--receive", metavar="PATH")
    p.add_argument("--image", default=None,
                   help="colorspace .bytes file (default: a seeded id image)")
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--out", default=None, help="recovered frame PNG path")
    p.add_argument("--out-bytes", default=None,
                   help="recovered frame as colorspace .bytes")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ott.Modulation])
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("lab3c_image")
    dev = resolve_device(args.device)
    mod = ott.Modulation(args.modulation)

    if args.transmit:
        raw = load_image(args.image, args.width, args.height)
        coded = rs.encode_stream(raw)
        tx = to_host(ott.encode(coded, guard_bands=True, modulation=mod,
                                device=dev))
        write_iq(args.transmit, tx)
        log.info("wrote %d samples (%d-byte image, RS-coded %d) to %s",
                 tx.size, raw.size, coded.size, args.transmit)
        return 0

    samples = read_iq(args.receive)
    if args.start is not None or args.stop is not None:
        samples = samples[args.start or 0: args.stop]
    try:
        out = ott.decode(samples, guard_bands=True, modulation=mod, device=dev)
    except ott.DecodeError as e:
        log.error("decode failed: %s", e)
        return 1
    decoded, ok = rs.decode_stream(out)
    if not ok:
        log.error("FEC uncorrectable")
        return 1
    n = args.width * args.height
    frame = decoded[:n]
    log.info("recovered %d-pixel frame", n)
    if args.out_bytes:
        pathlib.Path(args.out_bytes).write_bytes(frame.tobytes())
        log.info("wrote %s", args.out_bytes)
    if args.out:
        from PIL import Image
        Image.fromarray(id_to_rgb(frame).reshape(args.height, args.width, 3),
                        "RGB").save(args.out)
        log.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
