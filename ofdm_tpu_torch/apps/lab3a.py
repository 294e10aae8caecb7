"""lab3a: simulated text loopback (port of ofdm_tpu/apps/lab3a.py, which
rebuilds examples/lab3a.rs:11-46).

Text corpus -> encode -> simulated channel (SNR 30, no CFO) -> decode -> BER
report and recovered-text printout, with npy debug taps of the transmitted
and channeled streams and of the decoder's intermediate signals
(``--taps``, into data/simulated/).  ``--seed`` seeds the channel's
``torch.Generator`` on ``--device``.
"""

from __future__ import annotations

import argparse

import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.core.corpus import (create_transmission_text,
                                        decipher_transmission_text)
from ofdm_tpu_torch.core.transfer import to_host
from ofdm_tpu_torch.obs import taps
from ofdm_tpu_torch.obs.logging import set_up_logging

from ofdm_tpu_torch.apps.common import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--msg-bytes", type=int, default=400)
    p.add_argument("--snr", type=float, default=30.0)
    p.add_argument("--cfo", action="store_true", help="inject carrier frequency offset")
    p.add_argument("--guard-bands", action="store_true")
    p.add_argument("--ecc", action="store_true", help="Reed-Solomon framing")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ott.Modulation])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--taps", action="store_true", help="write npy debug taps")
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("lab3a")
    dev = resolve_device(args.device)
    if args.taps:
        taps.enable()
    try:
        return _run(args, dev, log)
    finally:
        if args.taps:
            taps.disable()


def _run(args, dev, log):
    mod = ott.Modulation(args.modulation)
    data = create_transmission_text(args.msg_bytes, args.ecc)
    log.info("payload: %d bytes (%s, ecc=%s)", len(data), mod.name, args.ecc)

    tx = ott.encode(data, guard_bands=args.guard_bands, modulation=mod,
                    device=dev)
    log.info("transmitted %d samples", tx.shape[-1])
    rx = ott.channel(tx, snr=args.snr, timing_error=args.cfo,
                     generator=torch.Generator(dev).manual_seed(args.seed))
    if taps.enabled():
        taps.tap("transmitted_3a", to_host(tx))
        taps.tap("channeled_3a", to_host(rx))

    try:
        out = ott.decode(rx, guard_bands=args.guard_bands, modulation=mod)
    except ott.DecodeError as e:
        log.error("decode failed: %s", e)
        return 1

    n = min(len(out), len(data))
    analysis = ott.Analysis.new(data[:n], out[:n])
    log.info("analysis: errs=%d block_errs=%d ber=%.6f",
             analysis.num_errs, analysis.num_block_errs, analysis.err_rate)

    text = decipher_transmission_text(args.msg_bytes, out, args.ecc)
    print(text if text is not None else "<decode failed: FEC uncorrectable>")
    return 0 if analysis.num_errs == 0 else 2


if __name__ == "__main__":
    raise SystemExit(main())
