"""datatoframe: render a colorspace .bytes image (port of
ofdm_tpu/apps/datatoframe.py, which rebuilds examples/datatoframe.rs: the
display-path proof of concept, with a PNG file or a terminal preview instead
of a minifb window).  Without a file it renders the seeded id image the
other apps transmit.  Host-only: it takes no ``--device``."""

from __future__ import annotations

import argparse

from ofdm_tpu_torch.apps.common import load_image
from ofdm_tpu_torch.packets.colors import id_to_rgb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("bytes_file", nargs="?", default=None,
                   help="colorspace .bytes file (default: a --width x "
                        "--height id image from a seed)")
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--out", default=None, help="PNG output path")
    args = p.parse_args(argv)

    raw = load_image(args.bytes_file, args.width, args.height)
    n = args.width * args.height
    if raw.size < n:
        print(f"file has {raw.size} bytes, need {n}")
        return 1
    rgb = id_to_rgb(raw[:n]).reshape(args.height, args.width, 3)

    if args.out:
        from PIL import Image
        Image.fromarray(rgb, "RGB").save(args.out)
        print(f"wrote {args.out}")
    else:
        # coarse terminal preview: one block char per pixel, 24-bit ANSI
        for y in range(args.height):
            row = "".join(
                f"\x1b[48;2;{r};{g};{b}m " for r, g, b in rgb[y])
            print(row + "\x1b[0m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
