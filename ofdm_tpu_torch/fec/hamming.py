"""Hamming(7,4) forward error correction (port of ofdm_tpu/fec/hamming.py).

Layout, identical to the JAX package's:
- each byte splits into two nibbles, low nibble first (LSB-first, the modem
  bit order of src/utils.rs:21-27);
- each nibble d0..d3 maps to the systematic codeword [d0 d1 d2 d3 p0 p1 p2]
  with p = d @ P mod 2 (G = [I4 | P], H = [P^T | I3]);
- codeword bits are concatenated LSB-first and packed into bytes,
  zero-padded to a byte boundary.

Corrects any single bit error per 7-bit codeword.

Both directions are elementwise uint8 bit math in a codeword-SoA layout,
batched over leading axes, on the input's device: 8 codewords pack into 7
bytes, so the byte stream reshapes losslessly into [..., G, 7] groups and
every extraction, syndrome, correction and repack is a fixed-shape uint8
expression.  No bool bit tensor and no [..., 7] bit axis is built.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Parity generator P (4x3): p = d @ P mod 2.  G = [I4 | P], H = [P^T | I3].
# The codec below hard-codes the same algebra as bit expressions.
_P = np.array([[1, 1, 0],
               [1, 0, 1],
               [0, 1, 1],
               [1, 1, 1]], dtype=np.uint8)
_G = np.concatenate([np.eye(4, dtype=np.uint8), _P], axis=1)          # 4x7
_H = np.concatenate([_P.T, np.eye(3, dtype=np.uint8)], axis=1)        # 3x7


def encoded_len(n_bytes: int) -> int:
    """Encoded byte count for ``n_bytes`` of data: ceil(n*14/8)."""
    return -(-n_bytes * 14 // 8)


def _one(x: torch.Tensor) -> torch.Tensor:
    return x & 1


def encode(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n] -> uint8[..., ceil(n*14/8)] Hamming(7,4)-coded stream."""
    data = data.to(torch.uint8)
    n = data.shape[-1]
    # nibble stream, low nibble first: [..., 2n]
    nib = torch.stack([data & 15, data >> 4], dim=-1).reshape(
        *data.shape[:-1], 2 * n)
    d0, d1, d2, d3 = _one(nib), _one(nib >> 1), _one(nib >> 2), _one(nib >> 3)
    p0, p1, p2 = d0 ^ d1 ^ d3, d0 ^ d2 ^ d3, d1 ^ d2 ^ d3
    v = nib | (p0 << 4) | (p1 << 5) | (p2 << 6)             # 7-bit codewords
    # pack 8 codewords -> 7 bytes (codeword j occupies bits 7j..7j+6 of the
    # 56-bit group, LSB-first)
    n_code = 2 * n
    g = -(-n_code // 8)
    v = F.pad(v, (0, 8 * g - n_code)).reshape(*v.shape[:-1], g, 8)
    vj = v.unbind(-1)
    out = torch.stack([
        vj[0] | (vj[1] << 7),
        (vj[1] >> 1) | (vj[2] << 6),
        (vj[2] >> 2) | (vj[3] << 5),
        (vj[3] >> 3) | (vj[4] << 4),
        (vj[4] >> 4) | (vj[5] << 3),
        (vj[5] >> 5) | (vj[6] << 2),
        (vj[6] >> 6) | (vj[7] << 1),
    ], dim=-1).reshape(*v.shape[:-2], 7 * g)
    return out[..., :encoded_len(n)]


def decode(coded: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """uint8[..., m] coded stream -> uint8[..., n_bytes] corrected data.

    ``n_bytes``: original data length (the modem header supplies it).
    """
    coded = coded.to(torch.uint8)
    n_code = 2 * n_bytes
    g = -(-n_code // 8)
    pad = 7 * g - coded.shape[-1]
    if pad > 0:
        coded = F.pad(coded, (0, pad))
    b = coded[..., :7 * g].reshape(*coded.shape[:-1], g, 7)
    bj = b.unbind(-1)
    m = 127
    v = torch.stack([
        bj[0] & m,
        ((bj[0] >> 7) | (bj[1] << 1)) & m,
        ((bj[1] >> 6) | (bj[2] << 2)) & m,
        ((bj[2] >> 5) | (bj[3] << 3)) & m,
        ((bj[3] >> 4) | (bj[4] << 4)) & m,
        ((bj[4] >> 3) | (bj[5] << 5)) & m,
        ((bj[5] >> 2) | (bj[6] << 6)) & m,
        (bj[6] >> 1) & m,
    ], dim=-1)                                            # [..., g, 8] codewords
    d0, d1, d2, d3 = _one(v), _one(v >> 1), _one(v >> 2), _one(v >> 3)
    c4, c5, c6 = _one(v >> 4), _one(v >> 5), _one(v >> 6)
    # syndrome s = H @ c over GF(2); flip data bit j iff s == H[:, j]
    s0, s1, s2 = d0 ^ d1 ^ d3 ^ c4, d0 ^ d2 ^ d3 ^ c5, d1 ^ d2 ^ d3 ^ c6
    ns0, ns1, ns2 = s0 ^ 1, s1 ^ 1, s2 ^ 1
    nib = ((d0 ^ (s0 & s1 & ns2))
           | ((d1 ^ (s0 & ns1 & s2)) << 1)
           | ((d2 ^ (ns0 & s1 & s2)) << 2)
           | ((d3 ^ (s0 & s1 & s2)) << 3))                # [..., g, 8]
    lo, hi = nib[..., 0::2], nib[..., 1::2]
    out = (lo | (hi << 4)).reshape(*nib.shape[:-2], 4 * g)
    return out[..., :n_bytes]
