"""lab3b_image: image-over-radio loopback (port of
ofdm_tpu/apps/lab3b_image.py, which rebuilds examples/lab3b_image.rs).

Transmits a colorspace image (``--image``, or a seeded ``--width`` x
``--height`` id image) through the simulated channel with guard bands, RS
ECC and CFO, decodes it, checks it against what was sent and renders the
recovered frame (``--out``, a PNG; needs Pillow).
"""

from __future__ import annotations

import argparse

import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import (add_device_arg, load_image,
                                        resolve_device)
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.obs.logging import set_up_logging
from ofdm_tpu_torch.packets.colors import id_to_rgb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default=None,
                   help="colorspace .bytes file (default: a seeded id image)")
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--snr", type=float, default=25.0)
    p.add_argument("--out", default=None, help="write recovered frame as PNG")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("lab3b_image")
    dev = resolve_device(args.device)
    raw = load_image(args.image, args.width, args.height)
    coded = rs.encode_stream(raw)
    log.info("image %d bytes -> %d RS-coded", raw.size, coded.size)

    tx = ott.encode(coded, guard_bands=True, modulation=ott.Modulation.QPSK,
                    device=dev)
    rx = ott.channel(tx, snr=args.snr, timing_error=True,
                     generator=torch.Generator(dev).manual_seed(args.seed))
    out = ott.decode(rx, guard_bands=True, modulation=ott.Modulation.QPSK)

    decoded, ok = rs.decode_stream(out)
    if not ok:
        log.error("FEC uncorrectable")
        return 1
    recovered = decoded[: raw.size]
    analysis = ott.Analysis.new(raw, recovered)
    log.info("analysis (post-FEC): errs=%d ber=%.6f",
             analysis.num_errs, analysis.err_rate)

    if args.out:
        from PIL import Image
        rgb = id_to_rgb(recovered).reshape(args.height, args.width, 3)
        Image.fromarray(rgb, "RGB").save(args.out)
        log.info("wrote %s", args.out)
    return 0 if analysis.num_errs == 0 else 2


if __name__ == "__main__":
    raise SystemExit(main())
