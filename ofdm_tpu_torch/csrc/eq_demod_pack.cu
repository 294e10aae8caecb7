// eq_demod_pack.cu: the post-DFT tail of the OFDM receiver in one pass.
//
// Replaces the TPU kernel ofdm_tpu/kernels/demod_pallas.py::eq_demod_pack
// (_demod_kernel, _atan2_soft, _gray_planes, _pack_matrix_lanes) and extends
// it with the per-chunk CFO phase, which the TPU kernel could not take
// (ofdm_tpu/phy/rx.py:277-282).  Per OFDM block (row b, data block c) of
// the DFT output y at nbins selected bins (data bins first, then pilots),
// read from input block blocks[c] when a block table is given (the chunked
// route's slot of chunk c + chunk0, ofdm_tpu/phy/rx.py:742-828), else c:
//
//   rot   = exp(-j * f_delta[b] * ((c + chunk0) * sym_len))   (rx.py rot_dc)
//   e     = (y * rot) * (1 / h[b])                            (equalize)
//   phi   = mean over the pilot bins of atan2(e)              (pilot phase)
//   d     = e * exp(-j * phi)          at the data bins
//   code  = hard decision of d: BPSK, the reference QPSK table with its
//           (re<0, im==0) fallthrough, Gray QAM16/64/256 with rintf (round
//           half to even, as jnp.round/torch.round; roundf would round half
//           away from zero and move the decision thresholds)
//   bytes = the codes' bits, LSB-first, packed with integer shifts
//
// The equalizer multiplies by 1/h (computed in the kernel from h) instead
// of dividing by h: the two differ by a rounding of ~1 ulp, which at
// operating SNR is many orders of magnitude below the decision margin.
// atan2f and sincosf are the full-range CUDA functions (no fast-math).
//
// What bounds it on the H100, at the decode path's shape (B = 256 rows,
// NB = 228 blocks, nbins = 52, QAM64): it reads ~24 MB of f32 planes and
// writes ~2.1 MB of bytes, ~8 us at 3.35 TB/s; the arithmetic (~40 flops per
// bin plus one sincos per block and one atan2 per pilot) is far below the
// fp32 peak.  It is bound by DRAM bytes, so the design reads each plane
// element once, keeps the codes in shared memory and writes bytes directly
// (no int32 word bitcast, no 0/2^k matmuls).
//
// Design: one warp per OFDM block, kWarps blocks per CUDA block.  Lanes
// take the bins in turn; the pilot angles are summed with a warp shuffle;
// each lane then packs whole output bytes from the codes in shared memory.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int kHalf>
__device__ __forceinline__ unsigned gray_axis(float v) {
  constexpr int n_levels = 1 << kHalf;
  float q = rintf((v + static_cast<float>(n_levels - 1)) * 0.5f);
  q = fminf(fmaxf(q, 0.f), static_cast<float>(n_levels - 1));
  const unsigned rank = static_cast<unsigned>(q);
  return rank ^ (rank >> 1);
}

template <int kBps>
__device__ __forceinline__ unsigned decide(float dr, float di) {
  if constexpr (kBps == 1) {
    return dr > 0.f ? 1u : 0u;
  } else if constexpr (kBps == 2) {
    const bool l = dr >= 0.f;
    const bool r = l ? (di >= 0.f) : (di > 0.f);
    return (l ? 1u : 0u) | (r ? 2u : 0u);
  } else {
    return gray_axis<kBps / 2>(dr) | (gray_axis<kBps / 2>(di) << (kBps / 2));
  }
}

template <int kBps>
__global__ void __launch_bounds__(kWarps * 32)
eq_demod_pack_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                     long long row_stride, long long blk_stride, int nb,
                     int n_data, int n_pilots, const float2* __restrict__ h,
                     int nbins, const float* __restrict__ f_delta, int chunk0,
                     int sym_len, const int* __restrict__ blocks,
                     long long total, unsigned char* __restrict__ out,
                     int bytes_per_block) {
  extern __shared__ unsigned char s_codes[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= total) return;                  // the whole warp leaves together
  const long long b = g / nb;
  const int c = static_cast<int>(g - b * nb);
  unsigned char* codes = s_codes + warp * n_data;
  const long long src = blocks != nullptr ? blocks[c] : c;
  const float* pr = yr + b * row_stride + src * blk_stride;
  const float* pi = yi + b * row_stride + src * blk_stride;
  const float2* hb = h + b * nbins;

  // (c + chunk0) * sym_len is an exact integer below 2^24: the same f32
  // angle as the reference's f32 product
  const float ang = f_delta[b] * static_cast<float>((c + chunk0) * sym_len);
  float rs, rc;
  sincosf(ang, &rs, &rc);
  auto equalize = [&](int bin, float& er, float& ei) {
    const float y_r = pr[bin] * rc + pi[bin] * rs;   // y * (rc - j rs)
    const float y_i = pi[bin] * rc - pr[bin] * rs;
    const float2 hh = hb[bin];
    const float inv = 1.f / (hh.x * hh.x + hh.y * hh.y);
    const float ih_r = hh.x * inv, ih_i = -hh.y * inv;
    er = y_r * ih_r - y_i * ih_i;
    ei = y_r * ih_i + y_i * ih_r;
  };

  float cp = 1.f, sp = 0.f;
  if (n_pilots > 0) {
    float acc = 0.f;
    for (int p = lane; p < n_pilots; p += 32) {
      float er, ei;
      equalize(n_data + p, er, ei);
      acc += atan2f(ei, er);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    sincosf(acc / static_cast<float>(n_pilots), &sp, &cp);
  }
  for (int s = lane; s < n_data; s += 32) {
    float er, ei;
    equalize(s, er, ei);
    const float dr = er * cp + ei * sp;              // e * (cp - j sp)
    const float di = ei * cp - er * sp;
    codes[s] = static_cast<unsigned char>(decide<kBps>(dr, di));
  }
  __syncwarp();

  unsigned char* ob = out + g * bytes_per_block;     // rows are nb blocks long
  for (int n = lane; n < bytes_per_block; n += 32) {
    unsigned v = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int bit = 8 * n + q;
      const int s = bit / kBps;
      v |= ((static_cast<unsigned>(codes[s]) >> (bit - s * kBps)) & 1u) << q;
    }
    ob[n] = static_cast<unsigned char>(v);
  }
}

template <int kBps>
int launch(const float* yr, const float* yi, long long row_stride,
           long long blk_stride, int nb, int n_data, int n_pilots,
           const float2* h, int nbins, const float* f_delta, int chunk0,
           int sym_len, const int* blocks, long long total, unsigned char* out,
           cudaStream_t stream) {
  const long long grid = (total + kWarps - 1) / kWarps;
  if (grid > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kWarps) * n_data;
  eq_demod_pack_kernel<kBps><<<static_cast<unsigned>(grid), kWarps * 32, smem, stream>>>(
      yr, yi, row_stride, blk_stride, nb, n_data, n_pilots, h, nbins, f_delta,
      chunk0, sym_len, blocks, total, out, n_data * kBps / 8);
  return cudaGetLastError();
}

}  // namespace

// yr/yi: f32 planes with element (b, c, bin) at b*row_stride + c*blk_stride +
// bin.  h: complex64 [batch, nbins].  f_delta: f32 [batch].  blocks: null, or
// int32 [nb], the input block of each output block (trusted to lie inside
// the planes).  out: uint8 [batch, nb * n_data * bps / 8].  Returns a
// cudaError_t (0 on success).
extern "C" int ofdm_eq_demod_pack(const void* yr, const void* yi,
                                  long long row_stride, long long blk_stride,
                                  int batch, int nb, int nbins, int n_data,
                                  int n_pilots, int bps, const void* h,
                                  const void* f_delta, int chunk0, int sym_len,
                                  const void* blocks, void* out, void* stream) {
  if (batch <= 0 || nb <= 0 || n_data <= 0 || n_pilots < 0 ||
      n_data + n_pilots > nbins || (n_data * bps) % 8 != 0 ||
      kWarps * n_data > 48 * 1024 || (nb + chunk0) * static_cast<long long>(sym_len) >= (1 << 24)) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(batch) * nb;
  auto* py = static_cast<const float*>(yr);
  auto* pyi = static_cast<const float*>(yi);
  auto* ph = static_cast<const float2*>(h);
  auto* pf = static_cast<const float*>(f_delta);
  auto* pb = static_cast<const int*>(blocks);
  auto* po = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bps) {
    case 1: return launch<1>(py, pyi, row_stride, blk_stride, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, total, po, s);
    case 2: return launch<2>(py, pyi, row_stride, blk_stride, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, total, po, s);
    case 4: return launch<4>(py, pyi, row_stride, blk_stride, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, total, po, s);
    case 6: return launch<6>(py, pyi, row_stride, blk_stride, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, total, po, s);
    case 8: return launch<8>(py, pyi, row_stride, blk_stride, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, total, po, s);
    default: return cudaErrorInvalidValue;
  }
}
