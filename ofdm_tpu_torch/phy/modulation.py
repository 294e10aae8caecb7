"""Symbol mapping and hard-decision demapping (port of ofdm_tpu/phy/modulation.py).

BPSK/QPSK keep the reference bit conventions: bits are consumed LSB-first per
byte; QPSK maps the pair (l, r) to (sign, sign) with (1,1) -> 1+1j, l driving
the real axis, and its decision table keeps the reference's (re<0, im==0)
fallthrough to (0, 0).  QAM16/64/256 are Gray-coded square constellations on
odd-integer levels: the first half of a symbol's bits drives the I axis, the
second half the Q axis.  Decisions round half to even (``torch.round``, as
``jnp.round``), so the thresholds sit exactly on the even integers.

The packed forms work on uint8 codes with shifts and masks and build no bit
tensor; ``modulate_bits`` and ``demodulate_symbols`` are the bit-tensor forms
with the same tables and decisions.
"""

from __future__ import annotations

import enum
from functools import lru_cache

import numpy as np
import torch

from ..ops.fft import real_dtype


class Modulation(enum.Enum):
    BPSK = "bpsk"
    QPSK = "qpsk"
    QAM16 = "qam16"
    QAM64 = "qam64"
    QAM256 = "qam256"


BITS_PER_SYMBOL = {
    Modulation.BPSK: 1,
    Modulation.QPSK: 2,
    Modulation.QAM16: 4,
    Modulation.QAM64: 6,
    Modulation.QAM256: 8,
}


@lru_cache(maxsize=None)
def _gray_levels(n_bits: int) -> np.ndarray:
    """Index = Gray code (bits LSB-first), value = odd-integer level."""
    n = 1 << n_bits
    levels = np.zeros(n, dtype=np.float64)
    for rank in range(n):
        levels[rank ^ (rank >> 1)] = 2 * rank - (n - 1)
    return levels


@lru_cache(maxsize=None)
def _gray_from_rank(n_bits: int) -> np.ndarray:
    """Index = level rank (0..2^n-1 left to right), value = Gray code."""
    return np.array([r ^ (r >> 1) for r in range(1 << n_bits)], dtype=np.uint8)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis by ``n`` (any dtype, including uint8); a
    non-positive ``n`` leaves ``x`` as it is."""
    if n <= 0:
        return x
    return torch.cat([x, x.new_zeros((*x.shape[:-1], n))], dim=-1)


def _bits_to_int(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., k] -> int64, LSB-first."""
    k = bits.shape[-1]
    weights = torch.tensor([1 << i for i in range(k)], device=bits.device)
    return (bits.long() * weights).sum(dim=-1)


def _int_to_bits(vals: torch.Tensor, k: int) -> torch.Tensor:
    shifts = torch.arange(k, device=vals.device)
    return ((vals[..., None].long() >> shifts) & 1).to(torch.bool)


def modulate_bits(bits: torch.Tensor, scheme: Modulation,
                  dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """bool[..., n_bits] -> complex[..., n_syms].  Where n_bits is no
    multiple of the bits per symbol (QAM64's 6 against a byte stream) the
    tail is zero-padded into a last partial symbol: no bit is dropped."""
    bps = BITS_PER_SYMBOL[scheme]
    bits = bits.to(torch.bool)
    n_sym = -(-bits.shape[-1] // bps)
    bits = _pad_last(bits, n_sym * bps - bits.shape[-1])
    bits = bits.reshape(*bits.shape[:-1], n_sym, bps)
    rd = real_dtype(dtype)
    one = torch.ones((), dtype=rd, device=bits.device)
    if scheme is Modulation.BPSK:
        re = torch.where(bits[..., 0], one, -one)
        return torch.complex(re, torch.zeros_like(re))
    if scheme is Modulation.QPSK:
        return torch.complex(torch.where(bits[..., 0], one, -one),
                             torch.where(bits[..., 1], one, -one))
    # square QAM: the first half of the bits is the I Gray code, the rest Q
    half = bps // 2
    levels = torch.as_tensor(_gray_levels(half), dtype=rd, device=bits.device)
    return torch.complex(levels[_bits_to_int(bits[..., :half])],
                         levels[_bits_to_int(bits[..., half:])])


def modulate_bytes_packed(data: torch.Tensor, scheme: Modulation,
                          dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """uint8[..., n] payload bytes -> complex[..., ceil(n*8/bps)] symbols.

    A final partial symbol is zero-padded, so no bit is dropped (QAM64's six
    bits against a byte stream).
    """
    data = data.to(torch.uint8)
    bps = BITS_PER_SYMBOL[scheme]
    n = data.shape[-1]
    n_sym = -(-n * 8 // bps)
    if scheme is Modulation.QAM256:
        c = data
    else:
        gb = {1: 1, 2: 1, 4: 1, 6: 3}[bps]    # bytes per extract group
        gs = gb * 8 // bps                    # symbols per extract group
        n_grp = -(-n // gb)
        b = _pad_last(data, n_grp * gb - n)
        b = b.reshape(*b.shape[:-1], n_grp, gb)
        if bps == 1:
            cs = [(b[..., 0] >> j) & 1 for j in range(8)]
        elif bps == 2:
            cs = [(b[..., 0] >> (2 * j)) & 3 for j in range(4)]
        elif bps == 4:
            cs = [b[..., 0] & 15, b[..., 0] >> 4]
        else:                                  # 6: 3 bytes -> 4 symbols
            b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
            cs = [b0 & 63,
                  (b0 >> 6) | ((b1 & 15) << 2),
                  (b1 >> 4) | ((b2 & 3) << 4),
                  b2 >> 2]
        c = torch.stack(cs, dim=-1).reshape(*b.shape[:-2], n_grp * gs)
    c = c[..., :n_sym]
    rd = real_dtype(dtype)
    one = torch.ones((), dtype=rd, device=c.device)
    if scheme is Modulation.BPSK:
        re = torch.where(c != 0, one, -one)
        return torch.complex(re, torch.zeros_like(re))
    if scheme is Modulation.QPSK:
        re = torch.where((c & 1) != 0, one, -one)
        im = torch.where((c & 2) != 0, one, -one)
        return torch.complex(re, im)
    half = bps // 2
    levels = torch.as_tensor(_gray_levels(half), dtype=rd, device=c.device)
    re = levels[(c & ((1 << half) - 1)).long()]
    im = levels[(c >> half).long()]
    return torch.complex(re, im)


def _symbol_codes(re: torch.Tensor, im: torch.Tensor,
                  scheme: Modulation) -> torch.Tensor:
    """Hard-decision per-symbol bit codes: uint8[..., n_syms], bit 0 = the
    symbol's first bit on the wire."""
    if scheme is Modulation.BPSK:
        return (re > 0.0).to(torch.uint8)
    if scheme is Modulation.QPSK:
        l = re >= 0.0
        r = torch.where(l, im >= 0.0, im > 0.0)
        return l.to(torch.uint8) | (r.to(torch.uint8) << 1)
    half = BITS_PER_SYMBOL[scheme] // 2
    n_levels = 1 << half
    gray = torch.as_tensor(_gray_from_rank(half), device=re.device)

    def axis_code(v):
        rank = torch.clamp(torch.round((v + (n_levels - 1)) / 2.0),
                           0, n_levels - 1).long()
        return gray[rank]

    return axis_code(re) | (axis_code(im) << half)


def demodulate_symbols_packed(syms: torch.Tensor,
                              scheme: Modulation) -> torch.Tensor:
    """complex[..., n_syms] -> uint8[..., n_syms*bps//8] packed bytes
    (LSB-first; a trailing partial byte is dropped)."""
    bps = BITS_PER_SYMBOL[scheme]
    c = _symbol_codes(syms.real, syms.imag, scheme)
    n_sym = c.shape[-1]
    n_bytes = n_sym * bps // 8
    if scheme is Modulation.QAM256:
        return c[..., :n_bytes]
    g = {1: 8, 2: 4, 4: 2, 6: 4}[bps]          # symbols per pack group
    nb = g * bps // 8                          # bytes per pack group
    n_grp = -(-n_sym // g)
    c = _pad_last(c, n_grp * g - n_sym)
    c = c.reshape(*c.shape[:-1], n_grp, g)
    cj = [c[..., j] for j in range(g)]
    # uint8 shifts wrap: the bits shifted past bit 7 are dropped, as packing needs
    if bps == 1:
        out = cj[0]
        for j in range(1, 8):
            out = out | (cj[j] << j)
        out = out[..., None]
    elif bps == 2:
        out = (cj[0] | (cj[1] << 2) | (cj[2] << 4) | (cj[3] << 6))[..., None]
    elif bps == 4:
        out = (cj[0] | (cj[1] << 4))[..., None]
    else:                                      # 6: 4 symbols -> 3 bytes
        out = torch.stack([
            cj[0] | (cj[1] << 6),
            (cj[1] >> 2) | (cj[2] << 4),
            (cj[2] >> 4) | (cj[3] << 2),
        ], dim=-1)
    out = out.reshape(*out.shape[:-2], n_grp * nb)
    return out[..., :n_bytes]


def demodulate_symbols(syms: torch.Tensor, scheme: Modulation) -> torch.Tensor:
    """complex[..., n_syms] -> bool[..., n_syms * bits/sym] (hard decision),
    the bit-tensor form of ``demodulate_symbols_packed``."""
    re, im = syms.real, syms.imag
    if scheme is Modulation.BPSK:
        return re > 0.0
    if scheme is Modulation.QPSK:
        # the reference's decision table with its (re<0, im==0) fallthrough
        # to (0, 0), src/receiver.rs:165-184
        l = re >= 0.0
        r = torch.where(l, im >= 0.0, im > 0.0)
        return torch.stack([l, r], dim=-1).reshape(*syms.shape[:-1], -1)
    half = BITS_PER_SYMBOL[scheme] // 2
    n_levels = 1 << half
    gray = torch.as_tensor(_gray_from_rank(half), device=re.device)

    def axis_bits(v):
        rank = torch.clamp(torch.round((v + (n_levels - 1)) / 2.0),
                           0, n_levels - 1).long()
        return _int_to_bits(gray[rank], half)

    bits = torch.cat([axis_bits(re), axis_bits(im)], dim=-1)
    return bits.reshape(*syms.shape[:-1], -1)
