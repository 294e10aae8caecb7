"""The rate sweep behind an open-loop cell's fixed rate.

    python3 rxbench/sweep.py --workload <open-loop cell> --seed <n> \\
        [--seconds 10] [--fractions 0.7 0.8 ...]

Sets the cell up once, measures its closed-loop rate (one call after
another, each waited for), then offers load at each fraction of that rate
for ``--seconds``, and prints one JSON line per rate: the latency p95, the
buffers left unserved, and how much longer the last quarter of the buffers
waited than the first.  The knee is the highest rate whose backlog does not
grow; the cell's file takes 0.8 of it.  Needs a CUDA card; the benchmark's
own runs do not run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from rxbench import cell as cellmod, registry, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fractions", type=float, nargs="+",
                   default=[0.6, 0.7, 0.8, 0.9, 0.95, 1.0, 1.05, 1.1])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("rxbench.sweep needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    w = registry.cell(registry.benchmark(), args.workload)
    tr = dict(registry.traffic(w["traffic"]))
    run.prepare_program(device)
    c = registry.driver(tr["driver"]).Cell(registry.config(w["config"]), tr,
                                           args.seed, device)
    c.warm()
    closed = 1.0 / cellmod.timed_steps(c.step, 50, device)
    print(json.dumps({"closed_loop_per_s": closed}), flush=True)
    for f in args.fractions:
        c.tr = dict(tr, rate_per_s=f * closed)
        win = c.window(args.seconds, False)
        print(json.dumps({"fraction": f, "rate_per_s": f * closed,
                          **win.metrics, **win.figures,
                          "attempted": win.attempted, "failed": win.failed}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
