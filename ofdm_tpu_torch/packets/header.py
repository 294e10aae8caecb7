"""Frame header codec.

Wire-compatible with the reference's bincode-serialized
``Header { packet_length: u128 }`` (src/packets/mod.rs:20-32): 16 bytes,
little-endian u128 giving the payload byte count.

A copy (same code) of ``ofdm_tpu/packets/header.py``: any import under ``ofdm_tpu``
runs that package's ``__init__``, which imports jax, and this package
must run where jax is absent.  tests/test_torch_constants.py holds the
two copies equal.
"""

from __future__ import annotations

import dataclasses

HEADER_LEN = 16


@dataclasses.dataclass(frozen=True)
class Header:
    packet_length: int

    def to_bytes(self) -> bytes:
        return int(self.packet_length).to_bytes(HEADER_LEN, "little")

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        if len(data) < HEADER_LEN:
            raise ValueError(f"header needs {HEADER_LEN} bytes, got {len(data)}")
        return cls(int.from_bytes(bytes(data[:HEADER_LEN]), "little"))
