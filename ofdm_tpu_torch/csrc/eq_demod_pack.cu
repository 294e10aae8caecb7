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
// The equalizer multiplies by 1/h instead of dividing by h: the two differ
// by a rounding of ~1 ulp, which at operating SNR is many orders of
// magnitude below the decision margin.  atan2f and sincosf are the
// full-range CUDA functions (no fast-math).
//
// What bounds it on the H100, at the decode path's shape (B = 256 rows,
// NB = 228 blocks, nbins = 52, QAM64): it reads ~24 MB of f32 planes and
// writes ~2.1 MB of bytes, ~8 us at 3.35 TB/s; the arithmetic (~40 flops per
// bin plus one sincos per block and one atan2 per pilot) is far below the
// fp32 peak.  So the bytes should bind, but only if no lane idles and no
// per-bin work is repeated: the instruction issue of a warp per OFDM block
// (idle lanes, 1/h per block, a serial pilot chain, a bit-by-bit pack)
// held it at ~6x the bytes bound.
//
// Design: one CUDA block takes a tile of consecutive OFDM blocks of one row.
//   1. 1/h for the row's nbins bins goes to shared memory once per tile.
//   2. Per OFDM block, a group of P lanes (P = n_pilots rounded up to a power
//      of two, at most 32; 32 / P blocks per warp) computes rot (one
//      sincosf) and the pilot phase, kept in shared memory.  The pilots are
//      summed as lanes p, p + P, ... then a shuffle butterfly: the order of
//      a warp per block whose lanes past n_pilots hold +0 (for 4 pilots,
//      (a0 + a2) + (a1 + a3)).
//   3. Each thread takes G = 8 / gcd(8, bps) consecutive data symbols
//      (n_data * bps % 8 == 0 makes G divide n_data), equalizes them,
//      decides them in registers and writes its G * bps / 8 whole bytes:
//      no code buffer, no second pass.  Consecutive threads read
//      consecutive bins (as float4 / float2 where the planes are aligned)
//      and write consecutive bytes.
// Every element goes through the same roundings as in the earlier one-warp-
// per-block layout (spelled out below), so the bytes are those it wrote.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Symbols per thread: the fewest whose bits fill whole bytes.
template <int kBps>
__host__ __device__ constexpr int symbols_per_thread() {
  return kBps == 1 ? 8 : kBps == 2 ? 4 : kBps == 4 ? 2 : kBps == 6 ? 4 : 1;
}

// The roundings below are spelled out (fmaf, and __fmul_rn, which is never
// fused) as the one-warp-per-block kernel compiled them: which product the
// compiler fuses into an FMA depends on the code around it, and moving 1/h
// into shared memory changed its choice for ei, so the bytes would have
// moved with it.

// 1/h = ih_r + j ih_i
__device__ __forceinline__ float2 inv_h(float2 hh) {
  const float inv = 1.f / fmaf(hh.x, hh.x, __fmul_rn(hh.y, hh.y));
  return make_float2(__fmul_rn(hh.x, inv), -__fmul_rn(hh.y, inv));
}

// (y * rot) * (1/h), rot = rc - j rs
__device__ __forceinline__ void equalize(float y_re, float y_im, float rc,
                                         float rs, float2 ih, float& er,
                                         float& ei) {
  const float y_r = fmaf(y_re, rc, __fmul_rn(y_im, rs));
  const float y_i = fmaf(y_im, rc, -__fmul_rn(y_re, rs));
  er = fmaf(y_r, ih.x, -__fmul_rn(y_i, ih.y));
  ei = fmaf(y_i, ih.x, __fmul_rn(y_r, ih.y));
}

// e * (cp - j sp)
__device__ __forceinline__ void derotate(float er, float ei, float cp, float sp,
                                         float& dr, float& di) {
  dr = fmaf(er, cp, __fmul_rn(ei, sp));
  di = fmaf(ei, cp, -__fmul_rn(er, sp));
}

// v[0..G) = p[0..G): vector loads where the wrapper found the planes aligned
template <int G, bool kVec>
__device__ __forceinline__ void load_symbols(const float* __restrict__ p, float (&v)[G]) {
  if constexpr (kVec && G % 4 == 0) {
#pragma unroll
    for (int q = 0; q < G; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
    }
  } else if constexpr (kVec && G == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < G; ++q) v[q] = p[q];
  }
}

__device__ __forceinline__ long long src_block(const int* __restrict__ blocks, int c) {
  return blocks != nullptr ? blocks[c] : c;
}

// The G re and im values of item `it` (block it / n_grp of the tile from c0,
// symbols (it % n_grp) * G onwards).
template <int G, bool kVec>
__device__ __forceinline__ void load_item(const float* __restrict__ row_r,
                                          const float* __restrict__ row_i,
                                          const int* __restrict__ blocks,
                                          long long blk_stride, int c0, int n_grp,
                                          int it, float (&vr)[G], float (&vi)[G]) {
  const int blk = it / n_grp;
  const long long off = src_block(blocks, c0 + blk) * blk_stride + (it - blk * n_grp) * G;
  load_symbols<G, kVec>(row_r + off, vr);
  load_symbols<G, kVec>(row_i + off, vi);
}

template <int kBps, bool kVec>
__global__ void __launch_bounds__(kThreads)
eq_demod_pack_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                     long long row_stride, long long blk_stride, int nb,
                     int n_data, int n_pilots, int pilot_lanes,
                     const float2* __restrict__ h, int nbins,
                     const float* __restrict__ f_delta, int chunk0, int sym_len,
                     const int* __restrict__ blocks, int tile, int tiles_per_row,
                     unsigned char* __restrict__ out, int bytes_per_block) {
  constexpr int G = symbols_per_thread<kBps>();
  constexpr int kBytes = G * kBps / 8;
  extern __shared__ float4 s_mem[];
  float4* s_blk = s_mem;                                  // [tile]: rc, rs, cp, sp
  float2* s_ih = reinterpret_cast<float2*>(s_mem + tile); // [nbins]: 1/h

  const long long b = blockIdx.x / tiles_per_row;
  const int c0 = static_cast<int>(blockIdx.x - b * tiles_per_row) * tile;
  const int n_blk = min(tile, nb - c0);
  const int n_grp = n_data / G;
  const int items = n_blk * n_grp;
  const float* row_r = yr + b * row_stride;
  const float* row_i = yi + b * row_stride;

  // this thread's first symbols, loaded before the setup below
  int item = threadIdx.x;
  float vr[G], vi[G];
  if (item < items) load_item<G, kVec>(row_r, row_i, blocks, blk_stride, c0, n_grp, item, vr, vi);

  // 1. 1/h for the row's bins
  for (int bin = threadIdx.x; bin < nbins; bin += kThreads) s_ih[bin] = inv_h(h[b * nbins + bin]);
  __syncthreads();

  // 2. rot and the pilot phase of each block: pilot_lanes lanes per block
  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int per_warp = 32 / pilot_lanes;
    const int sub = lane % pilot_lanes;
    const float fd = f_delta[b];
    for (int blk0 = warp * per_warp; blk0 < n_blk; blk0 += kWarps * per_warp) {
      const int blk = blk0 + lane / pilot_lanes;
      const bool valid = blk < n_blk;
      const int c = c0 + (valid ? blk : 0);
      // (c + chunk0) * sym_len is an exact integer below 2^24: the same f32
      // angle as the reference's f32 product
      const float ang = fd * static_cast<float>((c + chunk0) * sym_len);
      float rs, rc;
      sincosf(ang, &rs, &rc);
      float cp = 1.f, sp = 0.f;
      if (n_pilots > 0) {
        const long long base = src_block(blocks, c) * blk_stride + n_data;
        float acc = 0.f;
        for (int p = sub; valid && p < n_pilots; p += pilot_lanes) {
          float er, ei;
          equalize(row_r[base + p], row_i[base + p], rc, rs, s_ih[n_data + p], er, ei);
          acc += atan2f(ei, er);
        }
        for (int o = pilot_lanes / 2; o > 0; o >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        }
        sincosf(acc / static_cast<float>(n_pilots), &sp, &cp);
      }
      if (valid && sub == 0) s_blk[blk] = make_float4(rc, rs, cp, sp);
    }
  }
  __syncthreads();

  // 3. G symbols per thread: equalize, remove the pilot phase, decide, pack
  unsigned char* row_out = out + b * static_cast<long long>(nb) * bytes_per_block;
  for (; item < items; item += kThreads) {
    if (item != threadIdx.x) {
      load_item<G, kVec>(row_r, row_i, blocks, blk_stride, c0, n_grp, item, vr, vi);
    }
    const int blk = item / n_grp;
    const int grp = item - blk * n_grp;
    const float4 s = s_blk[blk];
    unsigned v = 0;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float er, ei, dr, di;
      equalize(vr[q], vi[q], s.x, s.y, s_ih[grp * G + q], er, ei);
      derotate(er, ei, s.z, s.w, dr, di);
      v |= decide<kBps>(dr, di) << (q * kBps);
    }
    unsigned char* ob = row_out + static_cast<long long>(c0 + blk) * bytes_per_block
                        + grp * kBytes;
#pragma unroll
    for (int n = 0; n < kBytes; ++n) ob[n] = static_cast<unsigned char>(v >> (8 * n));
  }
}

bool aligned(const void* p, long long row_stride, long long blk_stride, int floats) {
  return reinterpret_cast<uintptr_t>(p) % (4u * floats) == 0 &&
         row_stride % floats == 0 && blk_stride % floats == 0;
}

template <int kBps>
int launch(const float* yr, const float* yi, long long row_stride,
           long long blk_stride, int batch, int nb, int n_data, int n_pilots,
           const float2* h, int nbins, const float* f_delta, int chunk0,
           int sym_len, const int* blocks, unsigned char* out,
           cudaStream_t stream) {
  constexpr int G = symbols_per_thread<kBps>();
  const int n_grp = n_data / G;
  const int tile = std::min(nb, std::max(1, kThreads / n_grp));
  const int tiles_per_row = (nb + tile - 1) / tile;
  const long long grid = static_cast<long long>(batch) * tiles_per_row;
  int pilot_lanes = 1;
  while (pilot_lanes < std::min(n_pilots, 32)) pilot_lanes *= 2;
  const size_t smem = tile * sizeof(float4) + nbins * sizeof(float2);
  if (grid > 0x7FFFFFFFll || smem > 48 * 1024) return cudaErrorInvalidValue;
  const int vec = G >= 4 ? 4 : G;
  const bool v = G > 1 && aligned(yr, row_stride, blk_stride, vec) &&
                 aligned(yi, row_stride, blk_stride, vec);
  auto kernel = v ? eq_demod_pack_kernel<kBps, true> : eq_demod_pack_kernel<kBps, false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      yr, yi, row_stride, blk_stride, nb, n_data, n_pilots, pilot_lanes, h,
      nbins, f_delta, chunk0, sym_len, blocks, tile, tiles_per_row, out,
      n_data * kBps / 8);
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
      (nb + chunk0) * static_cast<long long>(sym_len) >= (1 << 24)) {
    return cudaErrorInvalidValue;
  }
  auto* py = static_cast<const float*>(yr);
  auto* pyi = static_cast<const float*>(yi);
  auto* ph = static_cast<const float2*>(h);
  auto* pf = static_cast<const float*>(f_delta);
  auto* pb = static_cast<const int*>(blocks);
  auto* po = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bps) {
    case 1: return launch<1>(py, pyi, row_stride, blk_stride, batch, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, po, s);
    case 2: return launch<2>(py, pyi, row_stride, blk_stride, batch, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, po, s);
    case 4: return launch<4>(py, pyi, row_stride, blk_stride, batch, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, po, s);
    case 6: return launch<6>(py, pyi, row_stride, blk_stride, batch, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, po, s);
    case 8: return launch<8>(py, pyi, row_stride, blk_stride, batch, nb, n_data, n_pilots, ph, nbins, pf, chunk0, sym_len, pb, po, s);
    default: return cudaErrorInvalidValue;
  }
}
