"""Payload compression (realizes the reference's empty compression stub,
src/packets/compression.rs, whose intended brotli dependency was never wired
up — Cargo.toml:42).  Stdlib zlib keeps the image/byte payloads small before
FEC framing."""

from __future__ import annotations

import zlib

import numpy as np


def compress(data, level: int = 6) -> np.ndarray:
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else \
        np.asarray(data, dtype=np.uint8).tobytes()
    return np.frombuffer(zlib.compress(raw, level), np.uint8)


def decompress(data) -> np.ndarray:
    raw = bytes(data) if isinstance(data, (bytes, bytearray)) else \
        np.asarray(data, dtype=np.uint8).tobytes()
    return np.frombuffer(zlib.decompress(raw), np.uint8)
