"""Runs one cell of the benchmark once and prints its result as one JSON line.

    python3 rxbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``rxbench/`` and
the program, ``ofdm_tpu_torch``.  It needs as many CUDA cards as the cell
asks for, and exits non-zero with no result without them.

- Set-up: the cell's inputs are made on the card from ``--seed``, the
  program's kernels are built (only the first run in a checkout compiles;
  the builds stay under ``build/`` in the checkout), and every shape of the
  cell is warmed.  ``setup_s`` runs from the process's start to the start
  of the window.
- ``--trace 0``: one window of ``--seconds``; the result holds the cell's
  end-to-end metrics.
- ``--trace 1``: a window of ``--seconds`` untraced, for the host-clock
  figures, then one of the traffic's ``trace_seconds`` under
  ``torch.profiler``; the result holds the cell's per-layer metrics, the
  device's busy and window seconds, and ``breakdown``.
- Then the sampled answers are compared with the plain receiver's
  (``check.py``): the number and its limit end standard error and the
  result's line (``check``), and decide ``correct``.

The run exits non-zero, with no result, if JAX or the JAX package has been
imported once the windows have closed.
"""

from __future__ import annotations

import sys
from pathlib import Path

# run as a script, the folder of this file would shadow the standard
# library's modules of the same names: put the checkout's root there
sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from rxbench import check, registry, trace  # noqa: E402

IMPORTED_AT = time.clock_gettime(time.CLOCK_BOOTTIME)
BANNED = {"jax", "jaxlib", "flax", "ofdm_tpu"}


def process_age() -> float:
    """Seconds since this process started, from its start time in
    /proc/self/stat; since this module's import where that is unreadable."""
    now = time.clock_gettime(time.CLOCK_BOOTTIME)
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = now - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now - IMPORTED_AT
    return age if 0 <= age < 3600 else now - IMPORTED_AT


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def launch_counters() -> dict:
    """The launch counters of the program's hand kernels, by function name:
    every function of a public module of ``ofdm_tpu_torch.kernels`` that
    carries an int ``launches``.  A new kernel's counter is found with no
    edit here; two counted functions of one name raise."""
    import importlib
    import inspect
    import pkgutil

    import ofdm_tpu_torch.kernels as kernels
    found = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            n = getattr(fn, "launches", None)
            if fn.__module__ != mod.__name__ or type(n) is not int:
                continue
            if name in found:
                raise RuntimeError(f"two launch counters named {name!r}")
            found[name] = n
    return found


def prepare_program(device: torch.device) -> None:
    """The program's own settings for a card: full float32 matmuls (it
    refuses TF32) and its kernels built."""
    if device.type != "cuda":
        return
    from ofdm_tpu_torch.kernels import _build
    from ofdm_tpu_torch.ops.fft import set_full_fp32
    set_full_fp32()
    _build.build_all()


def run(bench: dict, name: str, seed: int, seconds: float, traced: bool,
        device: torch.device, data: Path = registry.HERE) -> dict:
    """One run of a cell; returns the result's fields."""
    w = registry.cell(bench, name)
    tr = registry.traffic(w["traffic"], data)
    limits = registry.limits(name, data)
    prepare_program(device)
    c = registry.driver(tr["driver"], data).Cell(
        registry.config(w["config"], data), tr, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    c.warm()
    metrics, extra = {}, {}
    wanted = registry.cell_metrics(bench, name, traced)
    if not traced:
        setup_s = process_age()
        win = c.window(seconds, False)
        windows = [win]
        values = {**win.metrics, "setup_s": setup_s}
    else:
        untraced = c.window(seconds, False)
        before = launch_counters()
        prof = trace.profiler()
        with prof:
            traced_win = c.window(min(seconds, tr["trace_seconds"]), True)
        after = launch_counters()
        windows = [untraced, traced_win]
        dev, host, t0, t1 = trace.events(prof)
        view = trace.View(
            device=dev, host=host, start_s=t0, end_s=t1,
            steps=traced_win.steps,
            counters={k: after[k] - before[k] for k in after},
            figures=untraced.figures, shapes=c.shapes,
            kind=torch.cuda.get_device_name(device) if cuda else "cpu")
        values = {m["name"]: registry.metric_reader(m["name"], data).read(view)
                  for m in wanted}
        extra = {"busy_s": view.busy_s(), "window_s": view.window_s}
    for m in wanted:
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": w["chips"], "memory_peak_bytes": peak, **extra}
    if cuda:
        device_info["power_limit"] = power_limit()
    result = {"correct": False,
              "attempted": sum(x.attempted for x in windows),
              "failed": sum(x.failed for x in windows),
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = trace.breakdown(view)
        del prof, view, dev, host
    answers = [a for x in windows for a in x.answers]
    del windows
    if cuda:
        torch.cuda.empty_cache()
    worst = check.worst(c, answers)
    result["correct"], result["check"] = check.judge(worst, limits)
    result["answers_compared"] = len(answers)
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    registry.validate(bench)
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rxbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    return emit(run(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0)))


def emit(result: dict) -> int:
    """Refuse a process that holds JAX or the JAX package; else print the
    compared numbers on standard error and the result as the last line of
    standard output, ``check`` its last key."""
    found = banned_modules()
    if found:
        print(f"rxbench: imported after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"answers compared {result.pop('answers_compared')}",
          file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    result["check"] = result.pop("check")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
