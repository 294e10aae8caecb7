"""A plain transmitter of the wire format (src/transmitter.rs:11-58) and the
Hamming(7,4) encoder of the coded streams, batched, on any device.

Computed in float64 and returned as complex64, so the samples a seed gives
do not depend on the matmul precision of the process.
"""

from __future__ import annotations

import numpy as np
import torch

from . import frame


def bytes_to_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> uint8 bits [..., 8 n], least significant first."""
    shifts = torch.arange(8, device=b.device, dtype=torch.uint8)
    return ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], -1)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., 8 n] (least significant first) -> uint8 [..., n]."""
    w = (1 << torch.arange(8, device=bits.device, dtype=torch.int32))
    g = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    return (g * w).sum(-1).to(torch.uint8)


def hamming_encode(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> the Hamming(7,4) code stream, uint8 [..., ceil(14 n / 8)]:
    nibbles low first, codeword bits d0 d1 d2 d3 p0 p1 p2 with p0 = d0+d1+d3,
    p1 = d0+d2+d3, p2 = d1+d2+d3 (mod 2), packed least significant first,
    zero-padded to a byte."""
    n = data.shape[-1]
    d = bytes_to_bits(data).reshape(*data.shape[:-1], 2 * n, 4)
    p = torch.stack([d[..., 0] ^ d[..., 1] ^ d[..., 3],
                     d[..., 0] ^ d[..., 2] ^ d[..., 3],
                     d[..., 1] ^ d[..., 2] ^ d[..., 3]], dim=-1)
    bits = torch.cat([d, p], dim=-1).reshape(*data.shape[:-1], 14 * n)
    m = -(-14 * n // 8)
    bits = torch.nn.functional.pad(bits, (0, 8 * m - 14 * n))
    return bits_to_bytes(bits)


def symbols(payload: torch.Tensor, modulation: str) -> torch.Tensor:
    """uint8 [..., n] -> complex128 [..., ceil(8 n / bps)] symbols; the last
    symbol's missing bits are zeros."""
    bps = frame.BITS_PER_SYMBOL[modulation]
    bits = bytes_to_bits(payload)
    n_sym = -(-bits.shape[-1] // bps)
    bits = torch.nn.functional.pad(bits, (0, n_sym * bps - bits.shape[-1]))
    bits = bits.reshape(*bits.shape[:-1], n_sym, bps).long()
    pm = bits.double() * 2.0 - 1.0
    if bps == 1:
        return torch.complex(pm[..., 0], torch.zeros_like(pm[..., 0]))
    if bps == 2:
        return torch.complex(pm[..., 0], pm[..., 1])
    half = bps // 2
    w = 1 << torch.arange(half, device=bits.device)
    levels = torch.as_tensor(frame.gray_levels(half), device=bits.device)
    return torch.complex(levels[(bits[..., :half] * w).sum(-1)],
                         levels[(bits[..., half:] * w).sum(-1)])


def _idft_cp(bins: np.ndarray) -> np.ndarray:
    """[k, CP + N] complex: bin values at ``bins`` -> a prefixed block."""
    n = np.arange(frame.N_FFT)
    w = np.exp(2j * np.pi * np.outer(bins, n) / frame.N_FFT) / frame.N_FFT
    return np.concatenate([w[:, -frame.CP_LEN:], w], axis=1)


def encode(data: torch.Tensor, modulation: str, guard_bands: bool = True
           ) -> torch.Tensor:
    """uint8 [B, L] payloads -> complex64 [B, SYNC_LEN + nb SYM_LEN] frames,
    the length header ahead of each payload."""
    b, n = data.shape
    header = torch.tensor(list(n.to_bytes(frame.HEADER_LEN, "little")),
                          dtype=torch.uint8, device=data.device)
    payload = torch.cat([header.expand(b, -1), data], dim=-1)
    syms = symbols(payload, modulation)
    bins = frame.data_bins(guard_bands)
    nb = frame.n_data_blocks(n, modulation, guard_bands)
    syms = torch.nn.functional.pad(syms, (0, nb * len(bins) - syms.shape[-1]))
    syms = syms.reshape(b, nb, len(bins))
    dev = data.device
    blocks = syms @ torch.as_tensor(_idft_cp(bins), device=dev)
    if guard_bands:
        pilots = _idft_cp(np.asarray(frame.PILOT_BINS)).sum(0)
        blocks = blocks + torch.as_tensor(pilots, device=dev)
    samples = torch.cat([torch.as_tensor(frame.sync_prefix(), device=dev)
                         .expand(b, -1), blocks.reshape(b, -1)], dim=-1)
    peak = torch.maximum(samples.real.amax(-1), samples.imag.amax(-1))
    return (samples / peak[:, None]).to(torch.complex64)
