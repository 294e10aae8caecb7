// sync_align.cu: fused frame sync and alignment for the batched OFDM receiver.
//
// Replaces the TPU kernel ofdm_tpu/kernels/align_pallas.py::sync_align
// (_sync_align_kernel, _take_window).  Per row r of a sample stream s[r, 0:T]:
//
//   c[lag]  = sum_{j<K} s[lag + j] * conj(tpl[j])   (s past T reads as 0)
//   power   = |c[lag]|^2 for lag < lag_bound
//   raw[r]  = (smallest lag among the maxima of power) - 1
//   off     = clamp(raw[r], 0, max_off)
//   out[r]  = s[r, off : off + need]
//
// The TPU kernel built the correlation as a banded-Toeplitz matmul on the MXU
// over 128-lane tiles.  Here it is K <= 128 fp32 multiply-adds per lag on the
// CUDA cores, with the samples and the template staged in shared memory; a
// real template (the locking ramp) takes half the multiply-adds.
//
// What bounds it on the H100, at the decode path's shape (R = 256 rows,
// T = 19,183 samples, need = 19,040, K = 80, real template):
//   - bytes: the stream is read once (~39 MB) and the window written once
//     (~39 MB): ~23 us at 3.35 TB/s.
//   - FLOPs: ~1.6 GFLOP of fp32 correlation (R * T * K * 2 planes * 2):
//     ~24 us at the 67 TFLOP/s fp32 peak.  The tensor cores are not used:
//     fp32 must not fall to TF32 (the QAM256 margin needs full fp32 sync).
//   - in this simple design the inner loop issues two shared-memory loads
//     per tap and lag, so shared-memory bandwidth, not DRAM or the FMA
//     units, is the expected limit.  Register tiling of consecutive lags
//     is the next step.
//
// Design:
//   kernel 1 (corr_argmax): grid (rows, lag blocks).  A block stages
//     kLagsPerBlock + K - 1 samples of both planes, computes the power of
//     its lags, and writes its best (power, lag) as one packed 64-bit key.
//     Rows of any length work: nothing assumes a row fits in shared memory.
//   kernel 2 (window): grid (rows, copy blocks).  Each block reduces its
//     row's keys (a second pass instead of atomics: deterministic, no
//     memset), derives the offset and copies its share of the window.
//
// Inputs and outputs are addressed through (row, plane, element) strides in
// floats, so complex64 [R, T] (interleaved) and planar f32 [R, 2, T] share
// one code path, and the window can be written as either form.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 128;
constexpr int kThreads = 256;
constexpr int kLagsPerBlock = 1024;
constexpr int kCopyPerThread = 4;
constexpr int kCopyPerBlock = kThreads * kCopyPerThread;

// The key orders by power, then by the SMALLER lag.  power is a sum of two
// squares, so it is +0 or positive (never -0: a square of -0 is +0); for
// IEEE-754 floats with the sign bit clear, the bit pattern read as an
// unsigned integer is monotonic in the value (exponent above mantissa), so
// comparing the keys as integers compares the powers as values.  A NaN
// power (NaN input) sorts above +inf and wins, as torch.argmax lets NaN win.
// No real lag reaches 0xFFFFFFFF, so key 0 is below every real candidate.
__device__ __forceinline__ unsigned long long pack_key(float power, int lag) {
  return (static_cast<unsigned long long>(__float_as_uint(power)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(lag));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// Max over the block; the result is valid in thread 0.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

template <bool kRealTemplate>
__global__ void __launch_bounds__(kThreads)
corr_argmax_kernel(const float* __restrict__ in, long long row_stride,
                   long long plane_stride, long long elem_stride, int t,
                   const float2* __restrict__ tpl, int k, int lag_bound,
                   unsigned long long* __restrict__ partial) {
  __shared__ float s_re[kLagsPerBlock + kMaxTaps];
  __shared__ float s_im[kLagsPerBlock + kMaxTaps];
  __shared__ float2 s_tpl[kMaxTaps];
  __shared__ unsigned long long s_warp[kThreads / 32];

  const int r = blockIdx.x;
  const int lag0 = blockIdx.y * kLagsPerBlock;
  const float* row = in + static_cast<long long>(r) * row_stride;
  for (int i = threadIdx.x; i < kLagsPerBlock + k - 1; i += kThreads) {
    const long long s = static_cast<long long>(lag0) + i;
    float vr = 0.f, vi = 0.f;
    if (s < t) {
      vr = row[s * elem_stride];
      vi = row[plane_stride + s * elem_stride];
    }
    s_re[i] = vr;
    s_im[i] = vi;
  }
  for (int j = threadIdx.x; j < k; j += kThreads) s_tpl[j] = tpl[j];
  __syncthreads();

  unsigned long long best = 0ull;
#pragma unroll
  for (int q = 0; q < kLagsPerBlock / kThreads; ++q) {
    const int l = threadIdx.x + q * kThreads;   // neighbouring threads, neighbouring lags
    const int lag = lag0 + l;
    if (lag < lag_bound) {
      float cr = 0.f, ci = 0.f;
      for (int j = 0; j < k; ++j) {
        const float xr = s_re[l + j];
        const float xi = s_im[l + j];
        const float2 w = s_tpl[j];
        if (kRealTemplate) {
          cr = fmaf(xr, w.x, cr);
          ci = fmaf(xi, w.x, ci);
        } else {                                // (xr + j xi) * (w.x - j w.y)
          cr = fmaf(xr, w.x, fmaf(xi, w.y, cr));
          ci = fmaf(xi, w.x, fmaf(-xr, w.y, ci));
        }
      }
      best = umax64(best, pack_key(fmaf(cr, cr, ci * ci), lag));
    }
  }
  best = block_max(best, s_warp);
  if (threadIdx.x == 0) partial[static_cast<long long>(r) * gridDim.y + blockIdx.y] = best;
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ in, long long row_stride,
              long long plane_stride, long long elem_stride,
              const unsigned long long* __restrict__ partial, int n_partial,
              int max_off, int need, int* __restrict__ raw_off,
              float* __restrict__ out, long long out_row, long long out_plane,
              long long out_elem) {
  __shared__ unsigned long long s_warp[kThreads / 32];
  __shared__ int s_off;
  const int r = blockIdx.x;
  const unsigned long long* keys = partial + static_cast<long long>(r) * n_partial;
  unsigned long long best = 0ull;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) best = umax64(best, keys[i]);
  best = block_max(best, s_warp);
  if (threadIdx.x == 0) {
    const unsigned lag = 0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull);
    const int raw = static_cast<int>(lag) - 1;
    if (blockIdx.y == 0) raw_off[r] = raw;
    s_off = min(max(raw, 0), max_off);
  }
  __syncthreads();

  const long long off = s_off;
  const float* src = in + static_cast<long long>(r) * row_stride;
  float* dst = out + static_cast<long long>(r) * out_row;
  const int begin = blockIdx.y * kCopyPerBlock;
  const int end = min(need, begin + kCopyPerBlock);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const long long s = (off + i) * elem_stride;
    dst[i * out_elem] = src[s];
    dst[out_plane + i * out_elem] = src[plane_stride + s];
  }
}

}  // namespace

// Number of 64-bit partial keys per row that ofdm_sync_align needs as scratch.
extern "C" int ofdm_sync_align_n_partial(int lag_bound) {
  return (lag_bound + kLagsPerBlock - 1) / kLagsPerBlock;
}

// Launch both kernels on `stream`.  Strides are in floats.  `partial` holds
// rows * ofdm_sync_align_n_partial(lag_bound) uint64; `raw_off` rows int32.
// Returns a cudaError_t (0 on success).
extern "C" int ofdm_sync_align(const void* in, long long row_stride,
                               long long plane_stride, long long elem_stride,
                               int rows, int t, const void* tpl, int k,
                               int real_template, int lag_bound, int need,
                               int max_off, void* partial, void* raw_off,
                               void* out, long long out_row,
                               long long out_plane, long long out_elem,
                               void* stream) {
  if (rows <= 0 || t <= 0 || k <= 0 || k > kMaxTaps || lag_bound <= 0 ||
      lag_bound > t || need <= 0 || need > t || max_off < 0 ||
      max_off > t - need) {
    return cudaErrorInvalidValue;
  }
  const int n_partial = ofdm_sync_align_n_partial(lag_bound);
  const int n_copy = (need + kCopyPerBlock - 1) / kCopyPerBlock;
  if (n_partial > 65535 || n_copy > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  auto* keys = static_cast<unsigned long long*>(partial);
  const dim3 g1(rows, n_partial);
  if (real_template) {
    corr_argmax_kernel<true><<<g1, kThreads, 0, s>>>(
        src, row_stride, plane_stride, elem_stride, t,
        static_cast<const float2*>(tpl), k, lag_bound, keys);
  } else {
    corr_argmax_kernel<false><<<g1, kThreads, 0, s>>>(
        src, row_stride, plane_stride, elem_stride, t,
        static_cast<const float2*>(tpl), k, lag_bound, keys);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  window_kernel<<<dim3(rows, n_copy), kThreads, 0, s>>>(
      src, row_stride, plane_stride, elem_stride, keys, n_partial, max_off,
      need, static_cast<int*>(raw_off), static_cast<float*>(out), out_row,
      out_plane, out_elem);
  return cudaGetLastError();
}
