// sync_align.cu: frame sync and alignment for the batched OFDM receiver.
//
// Three entry points, one library (they share the correlation pass and the
// window copy):
//
//   ofdm_sync_align          K1, replaces ofdm_tpu/kernels/align_pallas.py::
//                            sync_align (_sync_align_kernel, _take_window)
//   ofdm_planar_align        K3, replaces align_pallas.py::planar_align
//                            (_kernel): the window copy at given offsets
//   ofdm_sync_align_chunked  K4, replaces ofdm_tpu/kernels/chain_pallas.py::
//                            sync_align_chunked (_sync_chunk_kernel)
//
// Per row r of a sample stream s[r, 0:T]:
//
//   c[lag]  = sum_{j<K} s[lag + j] * conj(tpl[j])   (s past T reads as 0)
//   power   = |c[lag]|^2 for lag < lag_bound
//   raw[r]  = (smallest lag among the maxima of power) - 1
//   off     = clamp(raw[r], 0, max_off)
//   K1: out[r]  = s[r, off : off + need]
//   K3: out[r]  = s[r, offsets[r] : offsets[r] + need]   (offsets given, no sync)
//   K4: out[r, slot, lane] = s[r, off + sym * chunk(slot) + lane] (0 past T),
//       chunk(slot) = (slot % m_per) * n_cls + slot / m_per, 128 lanes
//
// The TPU kernel built the correlation as a banded-Toeplitz matmul on the MXU
// over 128-lane tiles.  Here it is K <= 128 fp32 multiply-adds per lag on the
// CUDA cores, with the samples and the template staged in shared memory; a
// real template (the locking ramp) takes half the multiply-adds.  K4's TPU
// kernel regrouped the window into chunk slots with 0/1 selection matmuls and
// lane rolls, a TPU trick: here every output lane is read straight from the
// stream by index arithmetic.
//
// What bounds them on the H100, at the decode path's shape (R = 256 rows,
// T = 19,120 samples, need = 19,040, K = 80, real template):
//   - bytes: the stream is read once (~39 MB) and the window written once
//     (~39 MB): ~23 us at 3.35 TB/s.  K3 is this copy alone.  K4 writes
//     256 slots x 128 lanes x 2 planes (~67 MB), ~32 us with its read.
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
//   kernel 2 (window, K1; chunk, K4): grid (rows, copy blocks).  Each block
//     reduces its row's keys (a second pass instead of atomics:
//     deterministic, no memset), derives the offset and copies its share.
//   K3 is kernel 2's copy with the offset read from an int32 array; it
//     trusts the offsets to lie in [0, T - need] (the wrapper's callers clip).
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
constexpr int kLanes = 128;                        // K4: samples per chunk slot
constexpr int kSlotsPerBlock = kCopyPerBlock / kLanes;

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

// The row's offset from its partial keys: every thread of the block gets
// clamp(argmax - 1, 0, max_off); the unclipped argmax - 1 goes to *raw_out
// when it is not null.
__device__ long long reduce_offset(const unsigned long long* __restrict__ keys,
                                   int n_partial, int max_off, int* raw_out) {
  __shared__ unsigned long long s_warp[kThreads / 32];
  __shared__ int s_off;
  unsigned long long best = 0ull;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) best = umax64(best, keys[i]);
  best = block_max(best, s_warp);
  if (threadIdx.x == 0) {
    const unsigned lag = 0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull);
    const int raw = static_cast<int>(lag) - 1;
    if (raw_out != nullptr) *raw_out = raw;
    s_off = min(max(raw, 0), max_off);
  }
  __syncthreads();
  return s_off;
}

// This block's share [begin, end) of a window copy: dst[i] = src[off + i].
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            long long plane_stride,
                                            long long elem_stride, long long off,
                                            float* __restrict__ dst,
                                            long long out_plane, long long out_elem,
                                            int need) {
  const int begin = blockIdx.y * kCopyPerBlock;
  const int end = min(need, begin + kCopyPerBlock);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const long long s = (off + i) * elem_stride;
    dst[i * out_elem] = src[s];
    dst[out_plane + i * out_elem] = src[plane_stride + s];
  }
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ in, long long row_stride,
              long long plane_stride, long long elem_stride,
              const unsigned long long* __restrict__ partial, int n_partial,
              int max_off, int need, int* __restrict__ raw_off,
              float* __restrict__ out, long long out_row, long long out_plane,
              long long out_elem) {
  const int r = blockIdx.x;
  const long long off = reduce_offset(
      partial + static_cast<long long>(r) * n_partial, n_partial, max_off,
      blockIdx.y == 0 ? raw_off + r : nullptr);
  copy_window(in + static_cast<long long>(r) * row_stride, plane_stride,
              elem_stride, off, out + static_cast<long long>(r) * out_row,
              out_plane, out_elem, need);
}

__global__ void __launch_bounds__(kThreads)
planar_align_kernel(const float* __restrict__ in, long long row_stride,
                    long long plane_stride, long long elem_stride,
                    const int* __restrict__ offsets, int need,
                    float* __restrict__ out, long long out_row,
                    long long out_plane, long long out_elem) {
  const int r = blockIdx.x;
  copy_window(in + static_cast<long long>(r) * row_stride, plane_stride,
              elem_stride, offsets[r], out + static_cast<long long>(r) * out_row,
              out_plane, out_elem, need);
}

// K4's second pass: kSlotsPerBlock slots of 128 lanes per block; every lane
// of every slot is written (samples past T, and the slots of chunks past the
// frame, read the stream or zeros, never uninitialised memory).
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const float* __restrict__ in, long long row_stride,
             long long plane_stride, long long elem_stride, int t,
             const unsigned long long* __restrict__ partial, int n_partial,
             int max_off, int sym, int n_cls, int m_per, int slots,
             float* __restrict__ out_re, float* __restrict__ out_im) {
  const int r = blockIdx.x;
  const long long off = reduce_offset(
      partial + static_cast<long long>(r) * n_partial, n_partial, max_off,
      nullptr);
  const float* src = in + static_cast<long long>(r) * row_stride;
  const long long row_out = static_cast<long long>(r) * slots * kLanes;
  const int s0 = blockIdx.y * kSlotsPerBlock;
  for (int e = threadIdx.x; e < kSlotsPerBlock * kLanes; e += kThreads) {
    const int slot = s0 + e / kLanes;
    if (slot >= slots) break;                 // e only grows: the rest is past too
    const int lane = e % kLanes;
    const int chunk = (slot % m_per) * n_cls + slot / m_per;
    const long long i = off + static_cast<long long>(sym) * chunk + lane;
    float vr = 0.f, vi = 0.f;
    if (i < t) {
      vr = src[i * elem_stride];
      vi = src[plane_stride + i * elem_stride];
    }
    const long long o = row_out + static_cast<long long>(slot) * kLanes + lane;
    out_re[o] = vr;
    out_im[o] = vi;
  }
}

// kernel 1 on `s`: the partial keys of every row.
cudaError_t launch_corr(const float* src, long long row_stride,
                        long long plane_stride, long long elem_stride, int rows,
                        int t, const void* tpl, int k, int real_template,
                        int lag_bound, int n_partial, unsigned long long* keys,
                        cudaStream_t s) {
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
  return cudaGetLastError();
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
  cudaError_t e = launch_corr(src, row_stride, plane_stride, elem_stride, rows,
                              t, tpl, k, real_template, lag_bound, n_partial,
                              keys, s);
  if (e != cudaSuccess) return e;
  window_kernel<<<dim3(rows, n_copy), kThreads, 0, s>>>(
      src, row_stride, plane_stride, elem_stride, keys, n_partial, max_off,
      need, static_cast<int*>(raw_off), static_cast<float*>(out), out_row,
      out_plane, out_elem);
  return cudaGetLastError();
}

// K3: row r of `out` gets `need` samples of row r of `in` from offsets[r]
// (int32, trusted to lie in [0, T - need]).  Strides are in floats.
extern "C" int ofdm_planar_align(const void* in, long long row_stride,
                                 long long plane_stride, long long elem_stride,
                                 int rows, const void* offsets, int need,
                                 void* out, long long out_row,
                                 long long out_plane, long long out_elem,
                                 void* stream) {
  if (rows <= 0 || need <= 0) return cudaErrorInvalidValue;
  const int n_copy = (need + kCopyPerBlock - 1) / kCopyPerBlock;
  if (n_copy > 65535) return cudaErrorInvalidValue;
  planar_align_kernel<<<dim3(rows, n_copy), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), row_stride, plane_stride, elem_stride,
      static_cast<const int*>(offsets), need, static_cast<float*>(out),
      out_row, out_plane, out_elem);
  return cudaGetLastError();
}

// K4: kernel 1, then the slot-major chunk planes out_re/out_im, each f32
// [rows, slots, 128] contiguous.  The offset is clipped to [0, max_off].
extern "C" int ofdm_sync_align_chunked(const void* in, long long row_stride,
                                       long long plane_stride,
                                       long long elem_stride, int rows, int t,
                                       const void* tpl, int k,
                                       int real_template, int lag_bound,
                                       int max_off, int sym, int n_cls,
                                       int m_per, void* partial, void* out_re,
                                       void* out_im, void* stream) {
  const int slots = n_cls * m_per;
  if (rows <= 0 || t <= 0 || k <= 0 || k > kMaxTaps || lag_bound <= 0 ||
      lag_bound > t || max_off < 0 || max_off >= t || sym <= 0 ||
      sym > kLanes || n_cls <= 0 || m_per <= 0) {
    return cudaErrorInvalidValue;
  }
  const int n_partial = ofdm_sync_align_n_partial(lag_bound);
  const int n_copy = (slots + kSlotsPerBlock - 1) / kSlotsPerBlock;
  if (n_partial > 65535 || n_copy > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  auto* keys = static_cast<unsigned long long*>(partial);
  cudaError_t e = launch_corr(src, row_stride, plane_stride, elem_stride, rows,
                              t, tpl, k, real_template, lag_bound, n_partial,
                              keys, s);
  if (e != cudaSuccess) return e;
  chunk_kernel<<<dim3(rows, n_copy), kThreads, 0, s>>>(
      src, row_stride, plane_stride, elem_stride, t, keys, n_partial, max_off,
      sym, n_cls, m_per, slots, static_cast<float*>(out_re),
      static_cast<float*>(out_im));
  return cudaGetLastError();
}
