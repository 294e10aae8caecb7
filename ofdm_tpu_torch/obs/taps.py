"""Debug taps: named intermediate-signal dumps for offline inspection.

Rebuilds ``write_to_numpy_file`` (src/utils.rs:256-264): saves the real and
imaginary parts of a named stream to ``<dir>/<name>_{reals,imag}.npy``.  Tap
calls are cheap no-ops unless enabled, so the production path stays fused.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_TAP_DIR: Path | None = None


def enable(directory: str | os.PathLike = "data/simulated") -> None:
    global _TAP_DIR
    _TAP_DIR = Path(directory)
    _TAP_DIR.mkdir(parents=True, exist_ok=True)


def disable() -> None:
    global _TAP_DIR
    _TAP_DIR = None


def enabled() -> bool:
    return _TAP_DIR is not None


def tap(name: str, data) -> None:
    """Dump a complex stream's reals/imag as npy files (when enabled)."""
    if _TAP_DIR is None:
        return
    arr = np.asarray(data)
    np.save(_TAP_DIR / f"{name}_reals.npy", np.real(arr).astype(np.float64))
    np.save(_TAP_DIR / f"{name}_imag.npy", np.imag(arr).astype(np.float64))
