"""The reference transmitter's seeded draws, frozen for the benchmark.

``rand`` 0.8's ``StdRng`` (ChaCha12, seeded from a u64 by a PCG32 step) and
its ``gen_range(-1.0..1.0)`` f64 sampler, re-derived from their public
specifications (jkelleyrtp/ofdm src/transmitter.rs:75-96 draws the
preamble and training sequences with them).  A copy of the algorithm
``ofdm_tpu_torch/core/rustrng.py`` uses, kept here so that the traffic and
the reference receiver derive the wire constants without the program.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _pcg32_seed_expand(state: int, n_bytes: int) -> bytes:
    """rand_core 0.6 ``SeedableRng::seed_from_u64`` default implementation.

    Advances a PCG32 (XSH-RR) generator once per 4 output bytes.
    """
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    while len(out) < n_bytes:
        state = (state * MUL + INC) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = (state >> 59) & 31
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        out += x.to_bytes(4, "little")
    return bytes(out[:n_bytes])


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def _chacha_block(key_words, counter: int, nonce_words, rounds: int):
    """One ChaCha block (RFC 7539 core with the original 64/64 counter/nonce
    split used by rand_chacha): returns 16 little-endian u32 output words."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        *nonce_words,
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(a + b) & _MASK32 for a, b in zip(x, state)]


class ChaChaRng:
    """rand_chacha-compatible word-stream RNG (ChaCha12 for StdRng)."""

    def __init__(self, seed32: bytes, rounds: int = 12):
        assert len(seed32) == 32
        self.key = [int.from_bytes(seed32[i * 4:(i + 1) * 4], "little") for i in range(8)]
        self.rounds = rounds
        self.counter = 0
        self.nonce = [0, 0]
        self._buf: list[int] = []

    @classmethod
    def seed_from_u64(cls, seed: int, rounds: int = 12) -> "ChaChaRng":
        return cls(_pcg32_seed_expand(seed, 32), rounds=rounds)

    def _refill(self):
        self._buf = _chacha_block(self.key, self.counter, self.nonce, self.rounds)
        self.counter += 1

    def next_u32(self) -> int:
        if not self._buf:
            self._refill()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def gen_range_f64(self, low: float, high: float) -> float:
        """rand 0.8 ``UniformFloat<f64>`` sampler for ``low..high``."""
        scale = high - low
        # Guard identical to rand's: shrink scale until max output < high.
        max_rand = 1.0 - np.finfo(np.float64).eps / 2.0
        while scale * max_rand + low >= high:
            scale = np.nextafter(scale, -np.inf)
        bits = self.next_u64()
        # value in [1, 2): 52 mantissa bits from the top of the u64
        mantissa = bits >> 12
        value1_2 = np.frombuffer(
            ((1023 << 52) | mantissa).to_bytes(8, "little"), dtype="<f8"
        )[0]
        return float((value1_2 - 1.0) * scale + low)


def complex_uniform_sequence(seed: int, n: int, scale: float = 1.0) -> np.ndarray:
    """Replicates ``preamble``/``training_signals`` generation
    (``src/transmitter.rs:75-96``): n draws of Complex64::new(U(-1,1), U(-1,1)) * scale."""
    rng = ChaChaRng.seed_from_u64(seed)
    out = np.empty(n, dtype=np.complex128)
    for i in range(n):
        re = rng.gen_range_f64(-1.0, 1.0)
        im = rng.gen_range_f64(-1.0, 1.0)
        out[i] = complex(re, im) * scale
    return out
