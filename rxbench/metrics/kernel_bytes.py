"""The bytes that bound the port's hand kernels, from a call's shapes.

Each input byte is read once and each output byte written once, whatever
the kernel reads again; scratch space is left out.  The operations are not
counted: they depend on how a sync is computed (direct correlation, FFT,
tensor-core GEMM), so a bound by bytes alone holds every implementation
that passes ``correct`` to the same work, and none can read above 100%.

- K1 ``sync_align`` (fused sync and window copy): reads complex64 rows
  [rows, t] and the template [taps], writes f32 planes [rows, 2, need] and
  int32 offsets [rows].
- K3 ``planar_align`` (window copy at given offsets): reads each row's
  window of a complex64 stream [rows, need] and int64 offsets [rows],
  writes f32 planes [rows, 2, need].
- K2 ``eq_demod_pack`` (equalize, demodulate, pack): reads f32 DFT planes
  [rows, blocks, 2 bins], complex64 channel [rows, bins] and f32 CFO
  [rows], writes uint8 [rows, blocks * carriers * bits / 8].
- ``derot_dft`` (derotate and DFT at the selected bins): reads f32 real and
  imaginary planes [rows, blocks, n] and f32 CFO [rows], writes f32
  [rows, blocks, 2 bins].
"""

COMPLEX64 = 8
F32 = 4


def k1_sync_align(rows: int, t: int, need: int, taps: int = 80) -> int:
    return rows * t * COMPLEX64 + taps * COMPLEX64 \
        + rows * 2 * need * F32 + rows * 4


def k3_planar_align(rows: int, need: int) -> int:
    return rows * need * COMPLEX64 + rows * 8 + rows * 2 * need * F32


def k2_eq_demod_pack(rows: int, blocks: int, bins: int, carriers: int,
                     bits: int) -> int:
    return (rows * blocks * 2 * bins * F32 + rows * bins * COMPLEX64
            + rows * F32 + rows * blocks * carriers * bits // 8)


def derot_dft(rows: int, blocks: int, n: int, bins: int) -> int:
    return (2 * rows * blocks * n * F32 + rows * blocks * 2 * bins * F32
            + rows * F32)
