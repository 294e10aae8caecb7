"""ber_sweep: BER waterfall curves over SNR per modulation scheme (port of
ofdm_tpu/apps/ber_sweep.py).

Sweeps the simulated channel's SNR, runs batched loopbacks on ``--device``
(encode, channel, decode_frame and the bit-error count stay there, one
number is fetched per point), and reports BER per (modulation, SNR) as JSON
plus a terminal waterfall plot.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.apps.common import add_device_arg, resolve_device
from ofdm_tpu_torch.core import device as device_mod
from ofdm_tpu_torch.obs.analysis import bit_errors
from ofdm_tpu_torch.obs.logging import set_up_logging
from ofdm_tpu_torch.packets.header import HEADER_LEN


def measure_ber(mod: ott.Modulation, snr: float, *, batch: int, payload: int,
                guard_bands: bool, cfo: bool, seed: int, device=None) -> float:
    """BER of ``batch`` x ``payload``-byte frames through encode, the
    channel at ``snr`` and ``decode_frame``, all on ``device`` (CUDA when
    None); the payload bytes come from numpy's ``default_rng(seed)``, the
    channel's noise from a ``torch.Generator`` seeded with ``seed``."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(
        rng.integers(0, 256, (batch, payload), dtype=np.uint8)).to(dev)
    tx = ott.encode(data, guard_bands=guard_bands, modulation=mod)
    rx = ott.channel(tx, snr=snr, timing_error=cfo,
                     generator=torch.Generator(dev).manual_seed(seed))
    nb = ott.n_data_blocks(payload, mod, guard_bands)
    out = ott.decode_frame(rx, n_blocks=nb, guard_bands=guard_bands,
                           modulation=mod)
    errs = bit_errors(out[:, HEADER_LEN:HEADER_LEN + payload], data).sum()
    return float(errs.item()) / (batch * payload * 8)


def measure_ber_awgn(mod: ott.Modulation, snr_db: float, *, n_bytes: int,
                     seed: int, device=None) -> float:
    """Symbol-level AWGN BER of the bare mapper at exact Es/N0: the
    decision-boundary measurement comparable to the analytic Gray curve
    (obs/ber_theory.py).  Data and noise are drawn with numpy exactly as the
    JAX app draws them, so the two measure equal BERs; the mapper and the
    demapper run on ``device``."""
    from ofdm_tpu_torch.obs.ber_theory import symbol_energy
    from ofdm_tpu_torch.phy.modulation import (demodulate_symbols_packed,
                                               modulate_bytes_packed)
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    syms = modulate_bytes_packed(torch.from_numpy(data).to(dev), mod) \
        .cpu().numpy()
    n0 = symbol_energy(mod) / 10.0 ** (snr_db / 10.0)
    noise = math.sqrt(n0 / 2.0) * (rng.standard_normal(syms.shape)
                                   + 1j * rng.standard_normal(syms.shape))
    noisy = torch.from_numpy((syms + noise).astype(np.complex64)).to(dev)
    got = demodulate_symbols_packed(noisy, mod).cpu().numpy()
    return float(np.unpackbits(got ^ data).sum()) / (n_bytes * 8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snrs", type=float, nargs="*",
                   default=[0, 5, 10, 15, 20, 25, 30])
    p.add_argument("--modulations", nargs="*",
                   default=["bpsk", "qpsk", "qam16", "qam64"])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--payload", type=int, default=256)
    p.add_argument("--guard-bands", action="store_true", default=True)
    p.add_argument("--cfo", action="store_true")
    p.add_argument("--json", action="store_true", help="JSON only, no plot")
    p.add_argument("--awgn-theory", action="store_true",
                   help="symbol-level AWGN sweep with the analytic Gray-QAM "
                        "curve printed alongside (Es/N0 dB)")
    add_device_arg(p)
    args = p.parse_args(argv)

    log = set_up_logging("ber_sweep")
    dev = resolve_device(args.device)
    if args.awgn_theory:
        from ofdm_tpu_torch.obs.ber_theory import ber_awgn
        results = {}
        for name in args.modulations:
            mod = ott.Modulation(name)
            rows = []
            for snr in args.snrs:
                meas = measure_ber_awgn(mod, snr, n_bytes=3 * (1 << 15),
                                        seed=int(snr * 10) + 7, device=dev)
                theo = ber_awgn(mod, snr)
                rows.append({"snr": snr, "measured": meas, "theory": theo})
                log.info("%s @ %.0f dB Es/N0: measured %.3e  theory %.3e",
                         mod.name, snr, meas, theo)
            results[name] = rows
        print(json.dumps({"snrs": args.snrs, "awgn": results}))
        return 0
    results = {}
    for name in args.modulations:
        mod = ott.Modulation(name)
        curve = []
        for snr in args.snrs:
            ber = measure_ber(mod, snr, batch=args.batch, payload=args.payload,
                              guard_bands=args.guard_bands, cfo=args.cfo,
                              seed=int(snr * 10) + 7, device=dev)
            curve.append(ber)
            log.info("%s @ %.0f dB: BER %.2e", mod.name, snr, ber)
        results[name] = curve

    print(json.dumps({"snrs": args.snrs, "ber": results}))
    if not args.json:
        # terminal waterfall: log10(BER) per curve
        floor = 1.0 / (args.batch * args.payload * 8)
        print("\nlog10(BER) (floor = %.1f):" % math.log10(floor))
        for name, curve in results.items():
            row = " ".join(
                f"{math.log10(max(b, floor)):6.2f}" for b in curve)
            print(f"  {name:6s} {row}")
        print("  snr    " + " ".join(f"{s:6.0f}" for s in args.snrs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
