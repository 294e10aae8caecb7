"""Readings of a cell's compared number for the program and for the control.

    python3 rxbench/control.py --workload <name> --seeds 11 12 13 ... \\
        [--control-seeds 3] [--seconds 1] [--out chiprun_out/control.jsonl]

For every seed the cell is set up as a run sets it up, the program runs a
short window at the cell's own load, and its sampled answers give the
program's reading of ``byte_mismatch_ppm`` (``check.py``): the lower
reading of the limit is the largest over a dozen seeds or more.  For the
first ``--control-seeds`` seeds the control follows: the plain receiver in
float32 with TF32 matmuls, put in the program's place on every input,
against the float64 receiver; the upper reading is its smallest.  The plain
receiver in float32 with TF32 off is read beside it.  One JSON line per
seed, printed and appended to ``--out``.  Needs a CUDA card; the
benchmark's own runs do not run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from rxbench import check, registry, run  # noqa: E402


@contextlib.contextmanager
def tf32_matmuls():
    """float32 matmuls in TF32 on the card, by the setting this PyTorch has
    (the new one where it exists: the two may not be mixed)."""
    m = torch.backends.cuda.matmul
    key = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    old = getattr(m, key)
    setattr(m, key, "tf32" if key == "fp32_precision" else True)
    try:
        yield
    finally:
        setattr(m, key, old)


def readings(cell, seconds: float, control: bool) -> dict:
    win = cell.window(seconds, False)
    expected = {}
    out = {"program": check.worst(cell, win.answers, expected=expected),
           "answers": len(win.answers)}
    if control:
        worst_tf32 = worst_f32 = 0.0
        for i in range(len(cell.inputs)):
            with tf32_matmuls():
                a = cell.reference(i, torch.float32).cpu().numpy()
            b = cell.reference(i, torch.float32).cpu().numpy()
            worst_tf32 = max(worst_tf32, check.mismatch_ppm(a, expected[i]))
            worst_f32 = max(worst_f32, check.mismatch_ppm(b, expected[i]))
        out.update(control_tf32=worst_tf32, reference_f32=worst_f32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="chiprun_out/control.jsonl")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("rxbench.control needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = registry.benchmark()
    w = registry.cell(bench, args.workload)
    tr = registry.traffic(w["traffic"])
    run.prepare_program(device)
    drv = registry.driver(tr["driver"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for n, seed in enumerate(args.seeds):
        cell = drv.Cell(registry.config(w["config"]), tr, seed, device)
        cell.warm()
        line = {"workload": args.workload, "seed": seed,
                **readings(cell, args.seconds, n < args.control_seeds)}
        del cell
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
