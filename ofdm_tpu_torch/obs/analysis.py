"""BER analysis (port of ofdm_tpu/obs/analysis.py).

``Analysis`` replicates the reference's (src/utils.rs:38-69): bit errors by
XOR-popcount, block (byte) errors and bit error rate, on the host with
numpy (a copy of the JAX package's, as are ``debug_data`` and ``trim_to``).
``bit_errors`` counts bit errors on the tensors' device, batched, for a sum
across devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Analysis:
    num_errs: int
    num_block_errs: int
    err_rate: float

    @classmethod
    def new(cls, left, right) -> "Analysis":
        a = np.frombuffer(bytes(left), dtype=np.uint8) if isinstance(
            left, (bytes, bytearray)) else np.asarray(left, dtype=np.uint8)
        b = np.frombuffer(bytes(right), dtype=np.uint8) if isinstance(
            right, (bytes, bytearray)) else np.asarray(right, dtype=np.uint8)
        assert a.shape == b.shape, "Analysis requires equal-length inputs"
        diff = np.bitwise_xor(a, b)
        num_errs = int(np.unpackbits(diff).sum())
        num_block_errs = int((diff != 0).sum())
        err_rate = num_errs / (a.size * 8.0) if a.size else 0.0
        return cls(num_errs, num_block_errs, err_rate)


def debug_data(left, right, limit: int | None = None) -> str:
    """Colored bit-diff printer (rebuilds utils.rs:207-219): green rows where
    sent == received, red where they differ.  Returns the rendered string."""
    a = np.asarray(left, dtype=np.uint8)
    b = np.asarray(right, dtype=np.uint8)
    n = min(a.size, b.size) if limit is None else min(a.size, b.size, limit)
    rows = []
    for idx in range(n):
        color = "\x1b[32m" if a[idx] == b[idx] else "\x1b[31m"
        rows.append(f"{color}> {idx} | {a[idx]:#010b}\n    | {b[idx]:#010b}\x1b[0m")
    return "\n".join(rows)


def trim_to(received: np.ndarray, block_size: int) -> np.ndarray:
    """Take only as many bytes as were sent (utils.rs:221-225)."""
    return np.asarray(received)[:block_size]


def bit_errors(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Bit-error count over the last axis of two uint8 tensors (int32)."""
    diff = left.to(torch.uint8) ^ right.to(torch.uint8)
    # popcount via 8 shifts
    shifts = torch.arange(8, dtype=torch.uint8, device=diff.device)
    bits = (diff[..., None] >> shifts) & 1
    return bits.sum(dim=(-1, -2)).to(torch.int32)
