"""Build the host libraries under native/ that the port's copies load.

``fec/reed_solomon.py`` loads ``native/librs_codec.so`` and ``io/capture.py``
loads ``native/libiq_loader.so`` when their modules are imported, and fall
back to numpy when the file is absent.  ``build`` compiles what is missing
or older than its source with native/Makefile's flags (without -fopenmp
where the compiler has no OpenMP runtime), each into a temporary file that
is then renamed over the library, so that no process can load a half-written
one; then it reloads those modules so that they load the new library.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[2] / "native"
# library -> the port's module that loads it at import
MODULES = {"rs_codec": "ofdm_tpu_torch.fec.reed_solomon",
           "iq_loader": "ofdm_tpu_torch.io.capture"}


def native_flags(cxx: str) -> list[str]:
    """native/Makefile's CXXFLAGS, without -fopenmp where the compiler has
    no OpenMP runtime (its pragmas then compile as plain loops: the RS
    codec runs on one thread per call)."""
    flags = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
    with tempfile.TemporaryDirectory() as tmp:
        probe = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o",
                                str(Path(tmp) / "probe")],
                               input="int main() { return 0; }\n",
                               capture_output=True, text=True)
    return flags + ["-fopenmp"] if probe.returncode == 0 else flags


def _stale(name: str) -> bool:
    so, src = NATIVE / f"lib{name}.so", NATIVE / f"{name}.cpp"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build(names: tuple[str, ...] = tuple(MODULES)) -> tuple[float, list[str]]:
    """Compile the named libraries that are missing or stale, all at once,
    and reload their modules; (seconds, the flags used, [] when nothing was
    compiled).  Raises RuntimeError where a build fails or a module still
    has no library: serving on the numpy RS codec is not measured."""
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    flags: list[str] = []
    if todo:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"no g++ to build native/ ({', '.join(todo)})")
        flags = native_flags(cxx)
        procs = []
        for name in todo:
            tmp = NATIVE / f".lib{name}.{os.getpid()}.so"
            cmd = [cxx, *flags, "-shared", "-o", str(tmp),
                   str(NATIVE / f"{name}.cpp")]
            procs.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [proc.communicate()[0] for *_, proc in procs]
        for (name, tmp, cmd, proc), log in zip(procs, logs):
            if proc.returncode != 0:
                for _, t, _, _ in procs:
                    t.unlink(missing_ok=True)
                raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{log}")
            os.replace(tmp, NATIVE / f"lib{name}.so")
    for name in names:
        module = importlib.import_module(MODULES[name])
        if module._LIB is None:
            module = importlib.reload(module)
        if module._LIB is None:
            raise RuntimeError(f"{MODULES[name]} did not load native/lib{name}.so")
    return time.perf_counter() - t0, flags


def uses_openmp(name: str) -> bool:
    """Whether native/lib{name}.so calls into the OpenMP runtime, that is,
    whether its parallel pragmas were compiled with -fopenmp."""
    return b"GOMP_parallel" in (NATIVE / f"lib{name}.so").read_bytes()
