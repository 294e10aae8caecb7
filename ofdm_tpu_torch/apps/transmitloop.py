"""transmitloop: periodic frame transmitter (port of
ofdm_tpu/apps/transmitloop.py, which realizes the reference's
examples/transmitloop.rs stub).

Cycles through the frames (``--gif``'s, which needs Pillow, or 8 seeded
24 x 24 id images), encoding each once and appending the IQ stream to a
rolling output file (or a counted dry run) at a configurable period: the
software stand-in for a periodic radio sender."""

from __future__ import annotations

import argparse
import time

import numpy as np

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import (add_device_arg, load_frames,
                                        resolve_device)
from ofdm_tpu_torch.core.transfer import to_host
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io.iqfile import sig_to_bytes
from ofdm_tpu_torch.obs.logging import set_up_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gif", default=None,
                   help="GIF whose frames to send (default: seeded id images)")
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--period", type=float, default=0.0, help="seconds between frames")
    p.add_argument("--out", default=None, help="append IQ stream to this file")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ott.Modulation])
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("transmitloop")
    dev = resolve_device(args.device)
    mod = ott.Modulation(args.modulation)
    _, frames = load_frames(args.gif)

    # batch-encode all unique frames once; the loop just replays
    coded = np.stack([rs.encode_stream(f) for f in frames])
    tx = to_host(ott.encode(coded, guard_bands=True, modulation=mod,
                            device=dev))

    out_f = open(args.out, "ab") if args.out else None
    try:
        for i in range(args.iterations):
            frame = tx[i % len(frames)]
            if out_f is not None:
                out_f.write(sig_to_bytes(frame))
            log.info("sent frame %d (%d samples)", i, frame.size)
            if args.period:
                time.sleep(args.period)
    finally:
        if out_f is not None:
            out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
