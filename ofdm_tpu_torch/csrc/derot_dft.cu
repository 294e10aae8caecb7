// derot_dft.cu: the matrix-derot front half's DFT at the selected bins, from
// the aligned planes, in one pass.
//
// Replaces no TPU kernel: the JAX package left this product to XLA
// (ofdm_tpu/ops/fft.py::dft_matmul_select_derot_planar, a per-row derotated
// DFT matrix and one matmul).  The port ran it as two cuBLAS fp32 batched
// products against a per-row matrix it wrote to device memory first
// (ofdm_tpu_torch/ops/fft.py::dft_matmul_select_derot_planar_reference).
// Per row r, OFDM block c and selected bin b_j:
//
//   y[r, c, j] = sum_{p<n} x[r, c, p] exp(-i w[r] (off + p)) exp(-2 pi i p b_j / n)
//
// read from the real and imaginary planes in place (any strides) and written
// as one contiguous f32 [R, C, 2k]: the k real parts, then the k imaginary
// parts of each block (the layout eq_demod_pack reads).
//
// What bounds it on the H100, at the batch decode's shape (R = 2,048, C =
// 228, n = 64, k = 52): the planes are read once (239 MB) and the product
// written once (194 MB), 0.129 ms at 3.35 TB/s.  A direct 64 x 52 complex
// product is 12.4 GFLOP of fp32 FMA, 0.19 ms at the 67 TFLOP/s peak, so it
// would be bound by its operations; the tensor cores are not used, since
// the products must stay full fp32 (no TF32, no split-TF32 sums).
//
// Design: the DFT is split as n = 8 * n2 (sample p = n2 p1 + p2, bin
// b = b1 + 8 b2), which leaves it bound by its bytes:
//   X[b] = sum_{p2 < n2} exp(-2 pi i p2 b / n) A_p2[b mod 8],
//   A_p2[q] = sum_{p1 < 8} x'[n2 p1 + p2] exp(-2 pi i p1 q / 8),
// x' the derotated samples.  About 1/3 of the direct form's operations at
// n = 64: eight radix-8 butterflies, then n2 multiply-adds per bin.
//   0. A block takes a tile of consecutive blocks of one row.  Its n
//      phasors exp(-i w (off + p)) are computed once (the angle is the f32
//      product w * (off + p), as the plain version forms it, then the
//      full-range sincosf), into shared memory.
//   1. One thread per (block, p2): it loads the 8 samples n2 p1 + p2 of
//      both planes (neighbouring threads read neighbouring samples),
//      derotates them in registers and takes their 8-point DFT, written to
//      shared memory as A[block][q][p2] (rows padded so that the reads of
//      step 2 fall in distinct banks).
//   2. A thread per bin j owns the column exp(-2 pi i p2 b_j / n), p2 < n2
//      (from a table the wrapper built in float64 and rounded to f32), and
//      sums A[block][b_j mod 8][p2] against it for each block of the tile;
//      neighbouring threads write neighbouring bins.  Up to n2 = 16 the
//      column is held in registers; the 256-point geometry's 32 twiddles
//      would spill, so there it is read through the read-only cache (the
//      table, at most 64 KB, is the same for every row).
// Nothing per row is written to device memory; all arithmetic is fp32 FMA
// and add, without fast-math intrinsics.  The kernel is templated on n2, so
// its loops unroll; it is built for the n_fft the package's geometries use,
// 32, 64, 80, 128 and 256 (n2 = 4, 8, 10, 16, 32).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// whether a thread keeps its bin's column of n2 twiddles in registers
__host__ __device__ constexpr bool column_in_registers(int n2) { return n2 <= 16; }
// resident blocks an SM should hold: 4 caps a thread at 64 registers,
// which a column of 9 to 16 twiddles, or step 2's 32-term sum, would spill
// from
__host__ __device__ constexpr int min_blocks(int n2) { return n2 > 8 ? 3 : 4; }
constexpr int kMaxBins = 256;     // = kThreads: one thread per bin
constexpr float kRsqrt2 = 0.70710678118654752f;

struct cplx {
  float re, im;
};

__device__ __forceinline__ cplx add(cplx a, cplx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cplx sub(cplx a, cplx b) { return {a.re - b.re, a.im - b.im}; }
// a * (-i)
__device__ __forceinline__ cplx mul_neg_i(cplx a) { return {a.im, -a.re}; }

// f = the 4-point DFT of (a, b, c, d)
__device__ __forceinline__ void dft4(cplx a, cplx b, cplx c, cplx d, cplx (&f)[4]) {
  const cplx t0 = add(a, c), t1 = sub(a, c), t2 = add(b, d), t3 = sub(b, d);
  f[0] = add(t0, t2);
  f[2] = sub(t0, t2);
  f[1] = add(t1, mul_neg_i(t3));
  f[3] = sub(t1, mul_neg_i(t3));
}

// In-place 8-point DFT, X[q] = sum_p v[p] exp(-2 pi i p q / 8), as two
// 4-point DFTs of the even and odd samples and one radix-2 combination.
__device__ __forceinline__ void dft8(cplx (&v)[8]) {
  cplx e[4], o[4];
  dft4(v[0], v[2], v[4], v[6], e);
  dft4(v[1], v[3], v[5], v[7], o);
  // o[q] *= exp(-2 pi i q / 8)
  o[1] = {(o[1].re + o[1].im) * kRsqrt2, (o[1].im - o[1].re) * kRsqrt2};
  o[2] = mul_neg_i(o[2]);
  o[3] = {(o[3].im - o[3].re) * kRsqrt2, -(o[3].re + o[3].im) * kRsqrt2};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = add(e[q], o[q]);
    v[q + 4] = sub(e[q], o[q]);
  }
}

// A[blk][q][p2] of step 1 sits at blk * (8 * kRow + 4) + q * kRow + p2
// (float2 units), kRow = row_len(n2) = the least length >= n2 that is 2 mod
// 4: rows start 16-byte aligned, so step 2 reads two p2 at once, and the 8
// rows q of a block start 4 mod 8 words apart, in distinct banks for the 8
// lanes of a quarter warp; blocks start 8 words apart mod 32 for step 1's
// stores.
__host__ __device__ constexpr int row_len(int n2) { return n2 + ((2 - n2) % 4 + 4) % 4; }

// One block: a tile of `tile` consecutive OFDM blocks of row r.  A tile
// gives each thread at most one (block, p2) of step 1 (tile * N2 <= kThreads).
template <int N2>
__global__ void __launch_bounds__(kThreads, min_blocks(N2))
derot_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 long long r_s0, long long r_s1, long long r_s2,
                 long long i_s0, long long i_s1, long long i_s2, int chunks,
                 int nbins, int bin_lanes, const float* __restrict__ omega,
                 int sample_offset, const int* __restrict__ bins,
                 const float2* __restrict__ twiddle, int tile,
                 int tiles_per_row, float* __restrict__ out) {
  static_assert(N2 % 2 == 0, "step 2 reads the column two twiddles at a time");
  constexpr int n = 8 * N2;
  constexpr int kRow = row_len(N2);
  constexpr int kBlk = 8 * kRow + 4;
  extern __shared__ float4 s_mem4[];
  float2* s_phasor = reinterpret_cast<float2*>(s_mem4);   // [n]
  float2* s_a = s_phasor + n;                             // [tile][kBlk]

  const long long r = blockIdx.x / tiles_per_row;
  const int c0 = static_cast<int>(blockIdx.x - r * tiles_per_row) * tile;
  const int n_blk = min(tile, chunks - c0);
  const int tid = threadIdx.x;

  // this thread's 8 samples of step 1 and its bin's column of step 2, loaded
  // before the phasors so that their latency overlaps the sincosf
  const int blk1 = tid / N2;
  const int p2 = tid - blk1 * N2;
  const bool loads = blk1 < n_blk;
  cplx v[8];
  if (loads) {
    const float* pr = xr + r * r_s0 + (c0 + blk1) * r_s1 + p2 * r_s2;
    const float* pi = xi + r * i_s0 + (c0 + blk1) * i_s1 + p2 * i_s2;
#pragma unroll
    for (int p1 = 0; p1 < 8; ++p1) v[p1] = {pr[p1 * N2 * r_s2], pi[p1 * N2 * i_s2]};
  }
  const int j = tid & (bin_lanes - 1);
  const bool has_bin = j < nbins;
  constexpr bool kRegs = column_in_registers(N2);
  float2 t[kRegs ? N2 : 1];
  int b1 = 0;
  if (has_bin) {
    b1 = bins[j] & 7;
    if constexpr (kRegs) {
#pragma unroll
      for (int q = 0; q < N2; ++q) t[q] = twiddle[q * nbins + j];
    }
  }

  // 0. the row's phasors exp(-i w (off + p)) = c - i s
  const float w = omega[r];
  for (int p = tid; p < n; p += kThreads) {
    float s, c;
    sincosf(w * static_cast<float>(sample_offset + p), &s, &c);
    s_phasor[p] = make_float2(c, s);
  }
  __syncthreads();

  // 1. derotate and take the 8-point DFT
  if (loads) {
#pragma unroll
    for (int p1 = 0; p1 < 8; ++p1) {
      const float2 d = s_phasor[N2 * p1 + p2];
      // x * (c - i s)
      v[p1] = {fmaf(v[p1].re, d.x, v[p1].im * d.y), fmaf(v[p1].im, d.x, -v[p1].re * d.y)};
    }
    dft8(v);
    float2* a = s_a + blk1 * kBlk + p2;
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q * kRow] = make_float2(v[q].re, v[q].im);
  }
  __syncthreads();

  // 2. bin j of every block of the tile: the N2-term sum against its column
  if (!has_bin) return;
  float* row_out = out + (r * chunks + c0) * (2LL * nbins);
  const float2* column = twiddle + j;
  // twiddle q of the column
  auto tw = [&](int q) -> float2 {
    if constexpr (kRegs) {
      return t[q];
    } else {
      return __ldg(column + q * nbins);
    }
  };
  for (int blk = tid / bin_lanes; blk < n_blk; blk += kThreads / bin_lanes) {
    const float2* a = s_a + blk * kBlk + b1 * kRow;
    float yr = 0.f, yi = 0.f;
#pragma unroll
    for (int q = 0; q < N2; q += 2) {
      const float4 x = *reinterpret_cast<const float4*>(a + q);   // p2 = q, q + 1
      const float2 t0 = tw(q), t1 = tw(q + 1);
      yr = fmaf(x.x, t0.x, fmaf(-x.y, t0.y, yr));
      yi = fmaf(x.x, t0.y, fmaf(x.y, t0.x, yi));
      yr = fmaf(x.z, t1.x, fmaf(-x.w, t1.y, yr));
      yi = fmaf(x.z, t1.y, fmaf(x.w, t1.x, yi));
    }
    float* o = row_out + blk * (2LL * nbins);
    o[j] = yr;
    o[nbins + j] = yi;
  }
}

template <int N2>
int launch(const float* xr, const float* xi, const long long (&st)[6], int rows,
           int chunks, int nbins, const float* omega, int sample_offset,
           const int* bins, const float2* twiddle, float* out, cudaStream_t stream) {
  constexpr int kRow = row_len(N2);
  // the least power of two >= nbins, at least a warp: a whole division of
  // kThreads, so step 2's threads split the tile's blocks evenly
  int bin_lanes = 32;
  while (bin_lanes < nbins) bin_lanes *= 2;
  const int tile_max = kThreads / N2;
  const int tiles_per_row = (chunks + tile_max - 1) / tile_max;
  const int tile = (chunks + tiles_per_row - 1) / tiles_per_row;
  const long long grid = static_cast<long long>(rows) * tiles_per_row;
  const size_t smem = (8 * N2 + static_cast<size_t>(tile) * (8 * kRow + 4)) * sizeof(float2);
  if (grid > 0x7FFFFFFFll || smem > 48 * 1024) return cudaErrorInvalidValue;
  derot_dft_kernel<N2><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      xr, xi, st[0], st[1], st[2], st[3], st[4], st[5], chunks, nbins, bin_lanes,
      omega, sample_offset, bins, twiddle, tile, tiles_per_row, out);
  return cudaGetLastError();
}

}  // namespace

// xr/xi: f32 planes with sample (r, c, p) at r*s0 + c*s1 + p*s2 (strides in
// elements, one set per plane).  omega: f32 [rows].  bins: int32 [nbins], the
// selected bins in [0, n_fft).  twiddle: complex64 [n_fft / 8, nbins],
// exp(-2 pi i ((p2 * bins[j]) mod n_fft) / n_fft).  out: f32 [rows, chunks,
// 2 * nbins], contiguous.  n_fft one of 32, 64, 80, 128 and 256; 1 <= nbins
// <= 256.
// Returns a cudaError_t (0 on success).
extern "C" int ofdm_derot_dft(const void* xr, const void* xi, long long r_s0,
                              long long r_s1, long long r_s2, long long i_s0,
                              long long i_s1, long long i_s2, int rows,
                              int chunks, int n_fft, int nbins,
                              const void* omega, int sample_offset,
                              const void* bins, const void* twiddle, void* out,
                              void* stream) {
  if (rows <= 0 || chunks <= 0 || n_fft % 8 != 0 || nbins <= 0 || nbins > kMaxBins ||
      sample_offset < 0 || sample_offset + n_fft >= (1 << 24)) {
    return cudaErrorInvalidValue;
  }
  const long long st[6] = {r_s0, r_s1, r_s2, i_s0, i_s1, i_s2};
  auto* pr = static_cast<const float*>(xr);
  auto* pi = static_cast<const float*>(xi);
  auto* pw = static_cast<const float*>(omega);
  auto* pb = static_cast<const int*>(bins);
  auto* pt = static_cast<const float2*>(twiddle);
  auto* po = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
#define OFDM_DEROT_CASE(N2) \
  case N2: return launch<N2>(pr, pi, st, rows, chunks, nbins, pw, sample_offset, pb, pt, po, s);
  switch (n_fft / 8) {
    OFDM_DEROT_CASE(4) OFDM_DEROT_CASE(8) OFDM_DEROT_CASE(10) OFDM_DEROT_CASE(16)
    OFDM_DEROT_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef OFDM_DEROT_CASE
}
