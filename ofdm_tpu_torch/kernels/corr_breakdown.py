"""Where the time of kernel 1's correlation pass (``corr_argmax_kernel`` in
``csrc/sync_align.cu``) goes on the card.

    python -m ofdm_tpu_torch.kernels.corr_breakdown

Builds copies of ``csrc/sync_align.cu`` (into
``build/ofdm_tpu_torch/corr_breakdown/``, one nvcc each, all at once): other
lags per thread and threads per block, one without its global loads (the
taps alone, on whatever shared memory holds) and one without its taps (the
staging alone).  Each runs ``ofdm_sync_align`` at the decode path's shape
(256 rows of 19,120 samples, the 80-tap locking template), and the device
time per call of the correlation pass and of the window pass comes from
torch.profiler.  The stripped copies compute wrong offsets; only their
times mean anything.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from .. import constants
from ..config import DEFAULT_CONFIG
from . import _build
from .align import declare_sync_lib, window_strides

OUT = _build.BUILD_DIR / "corr_breakdown"
ROWS, T, NEED, CALLS = 256, 19120, 19040, 20


def variants(src: str) -> dict:
    def edit(old: str, new: str) -> str:
        if old not in src:
            raise RuntimeError(f"csrc/sync_align.cu no longer holds {old!r}")
        return src.replace(old, new)

    def shape(lags: int, threads: int) -> str:
        v = re.sub(r"kCorrThreads = \d+;", f"kCorrThreads = {threads};", src)
        return re.sub(r"kLagsPerThread = \d+;", f"kLagsPerThread = {lags};", v)

    lags, threads = (int(re.search(rf"{n} = (\d+);", src).group(1))
                     for n in ("kLagsPerThread", "kCorrThreads"))
    out = {f"as built ({lags} lags x {threads} threads)": src}
    for other in ((8, 256), (12, 128), (16, 128)):
        if other != (lags, threads):
            out[f"{other[0]} lags x {other[1]} threads"] = shape(*other)
    out["taps alone (no global loads)"] = edit("    if (i < n_stage && s < t) {",
                                               "    if (k < 0) {")
    out["staging alone (no taps)"] = edit("  if (first < lag_bound) {",
                                          "  if (first < 0) {")
    return out


def build(srcs: dict) -> dict:
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
        (d / "sync_align.cu").write_text(src)
        so = d / "libsync_align.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "sync_align.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = declare_sync_lib(ctypes.CDLL(str(so)))
    return libs


def device_ms(fn) -> dict:
    """Device ms per call of each kernel of ``fn``, over one profiler session
    of CALLS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = "correlation" if "corr_argmax" in e.name else "window"
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / CALLS
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("corr_breakdown needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(variants((_build.CSRC / "sync_align.cu").read_text()))
    tpl = constants.locking_for(DEFAULT_CONFIG).astype(np.complex64)
    rng = np.random.default_rng(0)
    x = torch.complex(torch.as_tensor(0.01 * rng.standard_normal((ROWS, T)), dtype=torch.float32),
                      torch.as_tensor(0.01 * rng.standard_normal((ROWS, T)), dtype=torch.float32)).to(dev)
    for r, d in enumerate(rng.integers(0, 200, ROWS)):
        x[r, d:d + len(tpl)] += torch.as_tensor(tpl, device=dev)
    w = torch.as_tensor(tpl, device=dev)
    print(f"corr_argmax_kernel at R={ROWS} T={T} K={len(tpl)}, device ms per call "
          f"(torch.profiler, {CALLS} calls) on {card}:")
    for name, lib in libs.items():
        partial = torch.empty((ROWS, lib.ofdm_sync_align_n_partial(T)), dtype=torch.int64, device=dev)
        raw = torch.empty(ROWS, dtype=torch.int32, device=dev)
        out = torch.empty((ROWS, 2, NEED), dtype=torch.float32, device=dev)

        def call(lib=lib, partial=partial, raw=raw, out=out):
            err = lib.ofdm_sync_align(
                x.data_ptr(), *window_strides(x), ROWS, T, w.data_ptr(), len(tpl), 1, T,
                NEED, T - NEED, partial.data_ptr(), raw.data_ptr(), out.data_ptr(),
                *window_strides(out), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, err, name)

        ms = device_ms(call)
        print(f"  correlation {ms['correlation']:.4f}, window {ms['window']:.4f}  {name}")


if __name__ == "__main__":
    main()
