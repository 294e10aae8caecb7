"""Bit packing (port of ofdm_tpu/core/bitops.py), LSB-first within a byte.

The reference's bit order is LSB-first: ``u8::to_bools`` emits bit 0 first
(src/utils.rs:21-27) and ``bools_to_u8`` is its inverse (src/utils.rs:30-36).
The tensor forms work on the input's device and over leading axes; the
``np_`` forms are the host versions.
"""

from __future__ import annotations

import numpy as np
import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n] -> bool[..., n*8], LSB-first per byte."""
    data = data.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).to(torch.bool)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., n*8] -> uint8[..., n], LSB-first per byte (a trailing
    partial byte is dropped)."""
    n = bits.shape[-1] // 8
    grouped = bits[..., : n * 8].reshape(*bits.shape[:-1], n, 8).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def np_bytes_to_bits(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data, bitorder="little")


def np_bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits, bitorder="little")
