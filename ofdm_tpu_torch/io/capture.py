"""Native-backed capture reader: chunked streaming from large IQ files.

Python front-end for native/iq_loader.cpp (mmap + planar deinterleave via
ctypes), with a numpy fallback.  Yields planar (re, im) float32 chunk pairs —
the exact layout ``core.transfer.to_device`` uploads — so large captures
stream to the accelerator without intermediate complex copies.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libiq_loader.so")
if os.path.exists(_LIB_PATH):
    try:
        _LIB = ctypes.CDLL(_LIB_PATH)
        _LIB.iq_open.restype = ctypes.c_void_p
        _LIB.iq_open.argtypes = [ctypes.c_char_p]
        _LIB.iq_n_samples.restype = ctypes.c_int64
        _LIB.iq_n_samples.argtypes = [ctypes.c_void_p]
        _LIB.iq_read_planar.restype = ctypes.c_int64
        _LIB.iq_read_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _LIB.iq_close.argtypes = [ctypes.c_void_p]
    except OSError:
        _LIB = None


class Capture:
    """A memory-mapped fc32 IQ capture file."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._handle = None
        self._mm = None
        if _LIB is not None:
            self._handle = _LIB.iq_open(self.path.encode())
            if not self._handle:
                raise OSError(f"iq_open failed for {self.path}")
            self.n_samples = int(_LIB.iq_n_samples(self._handle))
        else:
            self._mm = np.memmap(self.path, dtype="<f4", mode="r")
            self.n_samples = self._mm.size // 2

    def read_planar(self, start: int, count: int):
        """-> (re, im) float32 arrays of length <= count (clipped at EOF)."""
        if self._handle is not None:
            re = np.empty(count, np.float32)
            im = np.empty(count, np.float32)
            n = _LIB.iq_read_planar(
                self._handle, start, count,
                re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if n < 0:
                raise OSError("iq_read_planar failed")
            return re[:n], im[:n]
        inter = self._mm[2 * start: 2 * (start + count)]
        return (np.ascontiguousarray(inter[0::2]),
                np.ascontiguousarray(inter[1::2]))

    def chunks(self, chunk_len: int, overlap: int = 0) -> Iterator[tuple]:
        """Stream (re, im) chunk pairs with ``overlap`` samples of lookback
        (e.g. sym_len-1 so frame sync windows never straddle a seam)."""
        pos = 0
        while pos < self.n_samples:
            start = max(0, pos - overlap)
            re, im = self.read_planar(start, chunk_len + (pos - start))
            if re.size == 0:
                return
            yield re, im
            pos += chunk_len

    def close(self):
        if self._handle is not None:
            _LIB.iq_close(self._handle)
            self._handle = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
