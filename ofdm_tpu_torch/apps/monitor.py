"""monitor: live terminal dashboard for a running receive stream (port of
ofdm_tpu/apps/monitor.py, which realizes the reference's TUI-monitor intent:
examples/tui/ and examples/monitor.rs are stubs).

Renders per-buffer decode status, BER, CFO estimate, channel magnitude stem
plot and the equalized constellation, refreshing in place.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import add_device_arg, resolve_device
from ofdm_tpu_torch.core.corpus import create_transmission_text
from ofdm_tpu_torch.core.transfer import to_host
from ofdm_tpu_torch.io.feed import SampleFeed, synthetic_captures
from ofdm_tpu_torch.obs.plots import constellation, stem_plot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--buffers", type=int, default=6)
    p.add_argument("--buffer-len", type=int, default=32768)
    p.add_argument("--msg-bytes", type=int, default=256)
    p.add_argument("--snr", type=float, default=25.0)
    p.add_argument("--interval", type=float, default=0.0)
    p.add_argument("--no-clear", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    data = create_transmission_text(args.msg_bytes, ecc=False)
    tx = ott.encode(data, guard_bands=True, modulation=ott.Modulation.QPSK,
                    device=dev)

    # Every channel realization is made before the capture thread starts:
    # the producer thread stays host-only.
    frames = [to_host(ott.channel(tx, snr=args.snr, timing_error=True,
                                  generator=torch.Generator(dev).manual_seed(i)))
              for i in range(args.buffers)]

    source = synthetic_captures(args.buffers, 1, lambda i: frames[i],
                                args.buffer_len)

    with SampleFeed(source) as feed:
        for i, buf in enumerate(feed):
            t0 = time.perf_counter()
            try:
                # The host-parity ``decode``, not ``decode_frame``: the
                # dashboard wants the diagnostics (offset, f_delta, h_k,
                # constellation) and refreshes at human cadence; serving
                # paths use decode_frame or decode_regular.
                out, diag = ott.decode(buf, guard_bands=True,
                                       modulation=ott.Modulation.QPSK,
                                       device=dev, return_diagnostics=True)
                ok = True
            except ott.DecodeError:
                ok = False
            dt = time.perf_counter() - t0

            if not args.no_clear:
                sys.stdout.write("\x1b[2J\x1b[H")
            print(f"=== ofdm_tpu_torch monitor — buffer {i} ===")
            if not ok:
                print("decode FAILED — skipping buffer")
                continue
            n = min(len(out), len(data))
            a = ott.Analysis.new(data[:n], out[:n])
            print(f"decode ok in {dt * 1e3:.1f} ms | offset={diag['offset']} "
                  f"f_delta={float(diag['f_delta']):.5f} | "
                  f"errs={a.num_errs} ber={a.err_rate:.5f}")
            print("\n-- channel |h_k| --")
            print(stem_plot(np.abs(diag["h_k"]), width=80, height=12))
            print("\n-- equalized constellation --")
            print(constellation(diag["equalized"][:512], width=60, height=24))
            if args.interval:
                time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
