"""Exact analytic BER of the Gray-coded constellations under AWGN.

The reference left its QAM arms as empty stubs (src/transmitter.rs:135-136,
src/receiver.rs:185), so this framework's mappers (phy/modulation.py) have no
reference oracle — their decision boundaries are validated against the exact
closed-form BER of Gray-coded square QAM on the AWGN channel instead
(Cho & Yoon, "On the general BER expression of one- and two-dimensional
amplitude modulations", IEEE Trans. Commun. 50(7), 2002).  A
merely-suboptimal boundary (e.g. a wrong-by-one threshold costing ~2 dB)
shifts measured BER by >2x at the test operating points and cannot pass
(tests/test_ber_theory.py).

Conventions match the shipped constellations: odd-integer levels per axis
(+-1, +-3, ...), binary-reflected Gray code per axis LSB-first, average
symbol energy Es = 2*(M'^2 - 1)/3 for square QAM with M' levels/axis
(BPSK: Es = 1, real axis only).  SNR is Es/N0 with N0 the total complex
noise variance (N0/2 per real dimension).
"""

from __future__ import annotations

import math

from ..phy.modulation import BITS_PER_SYMBOL, Modulation


def q_func(x: float) -> float:
    """Gaussian tail probability Q(x) = P(N(0,1) > x)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _pam_bit_error(k: int, m: int, inv_sigma: float) -> float:
    """Exact error probability of the k-th Gray bit (1-indexed) of M-PAM with
    levels +-1..+-(M-1) and per-dimension noise std 1/inv_sigma."""
    total = 0.0
    p = 1 << (k - 1)
    for i in range(int((1 - 2.0 ** -k) * m)):
        w = ((-1) ** (i * p // m)) * (p - math.floor(i * p / m + 0.5))
        total += w * q_func((2 * i + 1) * inv_sigma)
    return (2.0 / m) * total


def ber_awgn(modulation: Modulation, snr_es_n0_db: float) -> float:
    """Exact BER of the Gray-coded constellation at Es/N0 (dB) under AWGN."""
    gs = 10.0 ** (snr_es_n0_db / 10.0)
    if modulation is Modulation.BPSK:
        # +-1 on the real axis, Es = 1, sigma^2 = N0/2 per dim
        return q_func(math.sqrt(2.0 * gs))
    bps = BITS_PER_SYMBOL[modulation]
    half = bps // 2
    m = 1 << half                       # levels per axis
    # 1/sigma = sqrt(2 gs / Es) with Es = 2 (m^2 - 1) / 3
    inv_sigma = math.sqrt(3.0 * gs / (m * m - 1.0))
    return sum(_pam_bit_error(k, m, inv_sigma) for k in range(1, half + 1)) / half


def symbol_energy(modulation: Modulation) -> float:
    """Average symbol energy Es of the shipped constellation."""
    if modulation is Modulation.BPSK:
        return 1.0
    half = BITS_PER_SYMBOL[modulation] // 2
    m = 1 << half
    return 2.0 * (m * m - 1.0) / 3.0
