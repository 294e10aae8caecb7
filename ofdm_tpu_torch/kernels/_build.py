"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``build/ofdm_tpu_torch/`` beside the package
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library.  ``ptxas -v`` output
(registers, shared memory, spills) is kept next to it as ``<lib>.log``.

Nothing is built or loaded at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ofdm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for this tree."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, so: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), tmp


def _finish(name: str, so: Path, proc: subprocess.Popen, tmp: Path) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    so.with_suffix(".log").write_text(err)
    os.replace(tmp, so)      # atomic: a concurrent build never sees half a file


def build_all(names: tuple[str, ...] | None = None) -> list[Path]:
    """Compile ``csrc/<name>.cu`` for each name (every source by default)
    whose library this tree lacks, one ``nvcc`` per source, all started at
    once.  Returns the libraries' paths in the order of ``names``."""
    if names is None:
        names = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    paths = [library_path(n) for n in names]
    started = [(n, so, *_start(n, so)) for n, so in zip(names, paths)
               if not so.exists()]
    try:
        for n, so, proc, tmp in started:
            _finish(n, so, proc, tmp)
    finally:                 # after a failure, stop the builds still running
        for _, _, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this tree's library already exists."""
    return build_all((name,))[0]


@lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    return ctypes.CDLL(str(build(name)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        lib.ofdm_error_string.restype = ctypes.c_char_p
        lib.ofdm_error_string.argtypes = [ctypes.c_int]
        msg = lib.ofdm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
