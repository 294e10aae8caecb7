"""stream_bytes: precompute the "video over radio" IQ files (port of
ofdm_tpu/apps/stream_bytes.py, which rebuilds examples/stream_bytes.rs:15-42).

RS-encodes each frame's colorspace bytes and writes ``tx_dance{i}.dat`` fc32
IQ files ready for loop transmission or replay through rx_stream.  The
frames are ``--gif``'s (needs Pillow) or, without one, 8 seeded 24 x 24 id
images.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import (add_device_arg, load_frames,
                                        resolve_device)
from ofdm_tpu_torch.core.transfer import to_host
from ofdm_tpu_torch.fec import reed_solomon as rs
from ofdm_tpu_torch.io.iqfile import write_iq
from ofdm_tpu_torch.obs.logging import set_up_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gif", default=None,
                   help="GIF whose frames to send (default: seeded id images)")
    p.add_argument("--out-dir", default="data")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ott.Modulation])
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("stream_bytes")
    dev = resolve_device(args.device)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    dims, frames = load_frames(args.gif)
    log.info("frames %sx%s, %d of them", dims[0], dims[1], len(frames))

    mod = ott.Modulation(args.modulation)
    # one batched encode for all frames
    coded = np.stack([rs.encode_stream(f) for f in frames])
    tx = to_host(ott.encode(coded, guard_bands=True, modulation=mod,
                            device=dev))
    for i in range(tx.shape[0]):
        path = out_dir / f"tx_dance{i}.dat"
        write_iq(path, tx[i])
        log.info("wrote %s (%d samples)", path, tx.shape[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
