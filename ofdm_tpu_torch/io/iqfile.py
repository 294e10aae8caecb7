"""IQ sample file I/O — wire-compatible with the reference and UHD.

The reference serializes Complex64 streams as interleaved little-endian f32
pairs (``sig_to_bytes``/``bytes_to_sig``, src/utils.rs:228-254), the same
"fc32" format UHD's ``tx_samples_from_file``/``rx_samples_to_file`` use
(data/transmit.sh:1), so ``.dat`` files round-trip between this framework,
the Rust reference, and real USRP captures.
"""

from __future__ import annotations

import os

import numpy as np


def sig_to_bytes(samples) -> bytes:
    """complex[...] -> interleaved f32 LE bytes (fc32).  Accepts numpy or
    device arrays (device complex is pulled via the split-transfer shim)."""
    from ..core.transfer import to_host
    arr = to_host(samples).astype(np.complex64)
    inter = np.empty(arr.size * 2, dtype="<f4")
    inter[0::2] = arr.real.reshape(-1)
    inter[1::2] = arr.imag.reshape(-1)
    return inter.tobytes()


def bytes_to_sig(data: bytes, dtype=np.complex128) -> np.ndarray:
    """Interleaved f32 LE bytes -> complex array (f64 by default, matching
    the reference's widening to Complex64-as-f64)."""
    inter = np.frombuffer(data[: len(data) - len(data) % 8], dtype="<f4")
    return (inter[0::2].astype(np.float64)
            + 1j * inter[1::2].astype(np.float64)).astype(dtype)


def write_iq(path: str | os.PathLike, samples: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(sig_to_bytes(samples))


def read_iq(path: str | os.PathLike, dtype=np.complex128) -> np.ndarray:
    with open(path, "rb") as f:
        return bytes_to_sig(f.read(), dtype=dtype)
