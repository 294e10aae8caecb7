// sync_align.cu: frame sync and alignment for the batched OFDM receiver.
//
// Four entry points, one library (they share the correlation pass and the
// window copy):
//
//   ofdm_sync_align          K1, replaces ofdm_tpu/kernels/align_pallas.py::
//                            sync_align (_sync_align_kernel, _take_window),
//                            in two kernels; ofdm_sync_align_one_pass is the
//                            same function in one kernel, for rows that fit
//   ofdm_planar_align        K3, replaces align_pallas.py::planar_align
//                            (_kernel): the window copy at given offsets
//   ofdm_sync_align_chunked  K4, replaces ofdm_tpu/kernels/chain_pallas.py::
//                            sync_align_chunked (_sync_chunk_kernel)
//   ofdm_sync_keys           K1's correlation pass and row reduce alone: one
//                            packed key per row, for the time-sharded sync
//
// Per row r of a sample stream s[r, 0:T]:
//
//   c[lag]  = sum_{j<K} s[lag + j] * conj(tpl[j])   (s past T reads as 0)
//   power   = |c[lag]|^2 for lag < lag_bound
//   raw[r]  = (smallest lag among the maxima of power) - 1
//   off     = clamp(raw[r], 0, max_off)
//   K1: out[r]  = s[r, off : off + need]
//   K3: out[r]  = s[r, offsets[r] : offsets[r] + need]   (offsets given, no sync;
//       0 past T; with row stride 0 every row reads the one stream s[0, :])
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
// What bounds K1 on the H100, at the batch benchmark's shape (R = 2,048
// rows, T = 19,120 samples, need = 19,040, K = 80, real template): two
// bounds, almost equal.
//   - bytes: the rows read once (313 MB) and the window written once
//     (312 MB): 625 MB, 0.187 ms at 3.35 TB/s.  K3 is this copy alone.
//     K4 writes 256 slots x 128 lanes x 2 planes a row.
//   - FLOPs: 12.5 GFLOP of fp32 correlation (R * T * K * 2 planes * 2):
//     0.187 ms at the 67 TFLOP/s fp32 peak.  The tensor cores are not used:
//     fp32 must not fall to TF32 (the QAM256 margin needs full fp32 sync),
//     and a 3xTF32 split would change the sum order and so the powers.
//   - an SM issues one shared-memory load per clock against four FMAs, so
//     a loop with a load per tap and lag is load-bound at ~6x the FMA time.
// Two kernels (a correlation pass, then a window pass that reads every row
// again) serialise the two bounds and move 938 MB where 625 MB would do.
// The one-pass kernel reads each row once and overlaps them: a row's staged
// samples feed both its correlation and its window, and with two or more
// CTAs resident on an SM, one CTA's loads and window stores run under
// another's FMAs.
//
// Design:
//   kernel 1 (corr_argmax): grid (rows, lag blocks).  A block stages
//     kLagsPerBlock + K samples of both planes, computes the power of its
//     lags, and writes its best (power, lag) as one packed 64-bit key.
//     Rows of any length work: nothing assumes a row fits in shared memory.
//     Each thread owns kLagsPerThread (L) consecutive lags, held as L pairs
//     of accumulators, and a window of L samples per plane in registers:
//     per tap it loads one new sample of each plane and one template tap,
//     and issues 2L FMAs (4L for a complex template), so the loop is bound
//     by the FMAs, not by the loads.  The taps come as float4 broadcasts
//     of 4 taps.  Threads L floats apart would meet in the same banks, so
//     the staged samples are padded: sample n sits at n + n / L, and
//     neighbouring threads read (L + 1) floats apart (an odd stride).
//     Every lag sums its taps j = 0..K-1 in the same fmaf chain as before
//     this layout, so each power, each key, every offset and the
//     first-occurrence tie-breaking are bitwise what the one-lag-per-thread
//     loop gave.  (Measured on the H100 at the decode path's shape: 8 lags
//     and 128 threads were the fastest of 8-16 lags and 128-256 threads,
//     each a rebuild of this file, profiled; a grid-stride loop
//     that loaded the next tile during the current one's taps, into
//     registers or by cp.async, was not faster.)
//   kernel 2 (window, K1; chunk, K4): grid (rows, copy blocks).  Each block
//     reduces its row's keys (a second pass instead of atomics:
//     deterministic, no memset), derives the offset and copies its share.
//   one pass (sync_window, K1 for rows that fit): one thread-block cluster
//     of C CTAs a row.  With P = max(lag_bound, need) / C rounded up to 8
//     and H = max(K, max_off), CTA c owns the lags and the window outputs
//     [c P, (c + 1) P) and stages samples [c P, (c + 1) P + H) of both
//     planes (0 past T) in the padded layout above, in chunks of one round
//     of lags, by cp.async: the taps of a round start once its chunk and
//     the next have landed, while later chunks are in flight.  The
//     correlation is kernel 1's loop (tap_group), so every power and key is
//     bitwise kernel 1's.  Each CTA reduces its best key, publishes it in
//     its shared memory, and after a cluster barrier every CTA takes the max
//     of the C keys through distributed shared memory: the integer max of
//     kernel 2, deterministic, no atomics.  CTA c then writes its outputs
//     from its staged samples off + i (the halo covers off <= max_off; 0
//     past T, as staged), as float4 stores where the output allows.  The
//     rows that fit are those whose staged share leaves room for two CTAs an
//     SM and whose grid fills the card (kernels/align.py::one_pass_cluster
//     decides); longer rows, and too few rows, take the two kernels.
//     (Measured on the H100 at the batch benchmark's shape: 256 threads, 4
//     CTAs a row and two chunks ahead were the fastest of 128-512 threads,
//     2-8 CTAs a row and 1-8 chunks ahead, 0.404-0.411 ms a call against
//     0.576-0.591 for the two kernels; unrolling the tap loop across groups
//     was slower.  Without its window stores the kernel takes 0.382 ms, so
//     the multiply-adds bound it, as they bound kernel 1.)
//   K3 is kernel 2's copy with the offset read from an int32 array, and
//     zeros where a row reads at or past T.  The batched decode's callers
//     clip its offsets to [0, T - need]; stream decoding gives it one
//     stream (row stride 0) and the offsets first + i * spacing, so every
//     frame of a capture is cut out of it in one launch, with no copy of
//     the stream, no host round trip for `first` and no padding however
//     far the last row runs past the end.  It trusts the offsets to be
//     non-negative.
//
// Inputs and outputs are addressed through (row, plane, element) strides in
// floats, so complex64 [R, T] (interleaved) and planar f32 [R, 2, T] share
// one code path, and the window can be written as either form.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 128;
constexpr int kThreads = 256;                      // copy kernels
// correlation pass: kLagsPerThread a multiple of 4 (float4 taps), even
// (so the padded stride kLagsPerThread + 1 is odd)
constexpr int kCorrThreads = 128;
constexpr int kLagsPerThread = 8;
constexpr int kLagsPerBlock = kCorrThreads * kLagsPerThread;
// staged samples per plane: the block's lags and K more (the last tap group
// preloads the window of a next group that never comes), padded
constexpr int kStage = kLagsPerBlock + kMaxTaps;
constexpr int kStagePadded = kStage + kStage / kLagsPerThread;
constexpr int kStagePerThread = (kStage + kCorrThreads - 1) / kCorrThreads;
// template taps, zero past K up to whole groups of kLagsPerThread
constexpr int kTapSlots = (kMaxTaps + kLagsPerThread - 1) / kLagsPerThread * kLagsPerThread;
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

// Max over a block of kBlock threads; the result is valid in thread 0.
template <int kBlock>
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? s_warp[threadIdx.x] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// One tap for one lag: c += x * conj(w), the order of the plain loop.
template <bool kRealTemplate>
__device__ __forceinline__ void tap(float xr, float xi, float wr, float wi,
                                    float& cr, float& ci) {
  if (kRealTemplate) {
    cr = fmaf(xr, wr, cr);
    ci = fmaf(xi, wr, ci);
  } else {                                      // (xr + j xi) * (wr - j wi)
    cr = fmaf(xr, wr, fmaf(xi, wi, cr));
    ci = fmaf(xi, wr, fmaf(-xr, wi, ci));
  }
}

// Taps j0 .. j0 + n - 1 (n <= L, j0 a multiple of L) for the thread's L
// lags.  On entry x[q] holds sample (first lag) + j0 + q; after tap u the
// slot x[u] takes sample (first lag) + j0 + L + u, so lag i reads
// x[(i + u) % L] at tap u, and on exit (n = L) the window has moved by L.
// p points at the padded sample (first lag) + j0, whose next L samples sit
// at p[L + 1 + u].
template <bool kRealTemplate>
__device__ __forceinline__ void tap_group(const float* __restrict__ pr,
                                          const float* __restrict__ pi,
                                          const float4* __restrict__ wr4,
                                          const float4* __restrict__ wi4, int j0,
                                          int n, float (&xr)[kLagsPerThread],
                                          float (&xi)[kLagsPerThread],
                                          float (&cr)[kLagsPerThread],
                                          float (&ci)[kLagsPerThread]) {
  constexpr int L = kLagsPerThread;
  float wr[L], wi[L];
#pragma unroll
  for (int q = 0; q < L; q += 4) {
    const float4 a = wr4[(j0 + q) / 4];
    wr[q] = a.x; wr[q + 1] = a.y; wr[q + 2] = a.z; wr[q + 3] = a.w;
    if (!kRealTemplate) {
      const float4 b = wi4[(j0 + q) / 4];
      wi[q] = b.x; wi[q + 1] = b.y; wi[q + 2] = b.z; wi[q + 3] = b.w;
    } else {
      wi[q] = wi[q + 1] = wi[q + 2] = wi[q + 3] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < L; ++u) {
    if (u < n) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        tap<kRealTemplate>(xr[(i + u) % L], xi[(i + u) % L], wr[u], wi[u],
                           cr[i], ci[i]);
      }
      xr[u] = pr[L + 1 + u];
      xi[u] = pi[L + 1 + u];
    }
  }
}

template <bool kRealTemplate>
__global__ void __launch_bounds__(kCorrThreads)
corr_argmax_kernel(const float* __restrict__ in, long long row_stride,
                   long long plane_stride, long long elem_stride, int t,
                   const float2* __restrict__ tpl, int k, int lag_bound,
                   unsigned long long* __restrict__ partial) {
  constexpr int L = kLagsPerThread;
  __shared__ float s_re[kStagePadded];
  __shared__ float s_im[kStagePadded];
  __shared__ float4 s_wr[kTapSlots / 4];
  __shared__ float4 s_wi[kTapSlots / 4];
  __shared__ unsigned long long s_warp[kCorrThreads / 32];

  const int r = blockIdx.x;
  const int lag0 = blockIdx.y * kLagsPerBlock;
  const float* row = in + static_cast<long long>(r) * row_stride;
  // staging: every load of the thread is issued before the first store, so
  // they are in flight together (a loop of load-then-store waits on each)
  const bool interleaved = plane_stride == 1 && elem_stride == 2;   // complex64
  const int n_stage = kLagsPerBlock + k;
  float2 v[kStagePerThread];
#pragma unroll
  for (int q = 0; q < kStagePerThread; ++q) {
    const int i = threadIdx.x + q * kCorrThreads;
    const long long s = static_cast<long long>(lag0) + i;
    v[q] = make_float2(0.f, 0.f);
    if (i < n_stage && s < t) {
      v[q] = interleaved ? reinterpret_cast<const float2*>(row)[s]
                         : make_float2(row[s * elem_stride], row[plane_stride + s * elem_stride]);
    }
  }
#pragma unroll
  for (int q = 0; q < kStagePerThread; ++q) {
    const int i = threadIdx.x + q * kCorrThreads;
    if (i < n_stage) {
      s_re[i + i / L] = v[q].x;
      s_im[i + i / L] = v[q].y;
    }
  }
  // taps past K are zero and never used (tap_group's n stops at K)
  float* wr = reinterpret_cast<float*>(s_wr);
  float* wi = reinterpret_cast<float*>(s_wi);
  for (int j = threadIdx.x; j < kTapSlots; j += kCorrThreads) {
    const float2 w = j < k ? tpl[j] : make_float2(0.f, 0.f);
    wr[j] = w.x;
    wi[j] = w.y;
  }
  __syncthreads();

  unsigned long long best = 0ull;
  const int first = lag0 + threadIdx.x * L;     // this thread's lags: first + 0..L-1
  if (first < lag_bound) {
    const float* pr = s_re + threadIdx.x * (L + 1);
    const float* pi = s_im + threadIdx.x * (L + 1);
    float xr[L], xi[L], cr[L], ci[L];
#pragma unroll
    for (int q = 0; q < L; ++q) {
      xr[q] = pr[q];
      xi[q] = pi[q];
      cr[q] = 0.f;
      ci[q] = 0.f;
    }
    int j0 = 0;
    for (; j0 + L <= k; j0 += L, pr += L + 1, pi += L + 1) {
      tap_group<kRealTemplate>(pr, pi, s_wr, s_wi, j0, L, xr, xi, cr, ci);
    }
    if (j0 < k) tap_group<kRealTemplate>(pr, pi, s_wr, s_wi, j0, k - j0, xr, xi, cr, ci);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (first + i < lag_bound) {
        best = umax64(best, pack_key(fmaf(cr[i], cr[i], ci[i] * ci[i]), first + i));
      }
    }
  }
  best = block_max<kCorrThreads>(best, s_warp);
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
  best = block_max<kThreads>(best, s_warp);
  if (threadIdx.x == 0) {
    const unsigned lag = 0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull);
    const int raw = static_cast<int>(lag) - 1;
    if (raw_out != nullptr) *raw_out = raw;
    s_off = min(max(raw, 0), max_off);
  }
  __syncthreads();
  return s_off;
}

// This block's share [begin, end) of a window copy: dst[i] = src[off + i],
// 0 where off + i >= t.
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            long long plane_stride,
                                            long long elem_stride, long long off,
                                            long long t, float* __restrict__ dst,
                                            long long out_plane, long long out_elem,
                                            int need) {
  const int begin = blockIdx.y * kCopyPerBlock;
  const int end = min(need, begin + kCopyPerBlock);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    float vr = 0.f, vi = 0.f;
    if (off + i < t) {
      const long long s = (off + i) * elem_stride;
      vr = src[s];
      vi = src[plane_stride + s];
    }
    dst[i * out_elem] = vr;
    dst[out_plane + i * out_elem] = vi;
  }
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ in, long long row_stride,
              long long plane_stride, long long elem_stride, int t,
              const unsigned long long* __restrict__ partial, int n_partial,
              int max_off, int need, int* __restrict__ raw_off,
              float* __restrict__ out, long long out_row, long long out_plane,
              long long out_elem) {
  const int r = blockIdx.x;
  const long long off = reduce_offset(
      partial + static_cast<long long>(r) * n_partial, n_partial, max_off,
      blockIdx.y == 0 ? raw_off + r : nullptr);
  copy_window(in + static_cast<long long>(r) * row_stride, plane_stride,
              elem_stride, off, t, out + static_cast<long long>(r) * out_row,
              out_plane, out_elem, need);
}

// ---- K1 in one pass (sync_window_kernel) ----

namespace cg = cooperative_groups;

constexpr int kOneThreads = 256;
// lags a round (one group of L lags a thread), and the samples a staged chunk
constexpr int kOneRound = kOneThreads * kLagsPerThread;
// chunks staged before the first round; each round stages one more (a round
// reads its own chunk and the next)
constexpr int kOneAhead = 2;
constexpr int kOneMaxCluster = 8;                  // the portable cluster size
// dynamic shared memory a CTA may take: two CTAs an SM (228 KB) with room
// for their static shared memory
constexpr int kOneMaxShared = 116736;

// where sample n of a staged share sits in its padded plane
__host__ __device__ __forceinline__ int padded_index(int n) {
  return n + n / kLagsPerThread;
}

// A CTA's share P of a row's lags and window outputs.
__host__ __device__ __forceinline__ int one_pass_share(int lag_bound, int need,
                                                       int cluster) {
  const int share = ((lag_bound > need ? lag_bound : need) + cluster - 1) / cluster;
  return (share + kLagsPerThread - 1) / kLagsPerThread * kLagsPerThread;
}

// Floats of one padded plane of a CTA's staged samples: its share and the
// halo H = max(K, max_off) (K: the taps of its last lags and the window of
// a next tap group that tap_group preloads; max_off: its last output's).
__host__ __device__ __forceinline__ int one_pass_plane(int share, int k,
                                                       int max_off) {
  const int n = share + (k > max_off ? k : max_off);
  return (padded_index(n) + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             int src_bytes) {
  // src_bytes 0 fills the float with 0
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One CTA of a row's cluster: grid (rows * cluster), cluster (cluster),
// `share` = one_pass_share(...), dynamic shared memory two padded planes of
// one_pass_plane(share, k, max_off) floats.
template <bool kRealTemplate>
__global__ void __launch_bounds__(kOneThreads)
sync_window_kernel(const float* __restrict__ in, long long row_stride,
                   long long plane_stride, long long elem_stride, int t,
                   const float2* __restrict__ tpl, int k, int lag_bound,
                   int need, int max_off, int share, int* __restrict__ raw_off,
                   float* __restrict__ out, long long out_row,
                   long long out_plane, long long out_elem) {
  constexpr int L = kLagsPerThread;
  extern __shared__ float4 s_dyn[];
  __shared__ float4 s_wr[kTapSlots / 4];
  __shared__ float4 s_wi[kTapSlots / 4];
  __shared__ unsigned long long s_warp[kOneThreads / 32];
  __shared__ unsigned long long s_key;
  __shared__ int s_off;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.dim_blocks().x);
  const long long r = blockIdx.x / n_cta;
  const int base = c * share;                   // this CTA's first lag and output
  const float* row = in + r * row_stride;
  float* s_re = reinterpret_cast<float*>(s_dyn);
  float* s_im = s_re + one_pass_plane(share, k, max_off);

  // the lags and outputs this CTA owns, and the samples they read
  const int n_lags = max(0, min(share, lag_bound - base));
  const int n_out = max(0, min(share, need - base));
  const int n_stage = max(n_lags > 0 ? (n_lags + L - 1) / L * L + k : 0,
                          n_out > 0 ? n_out + max_off : 0);
  const int n_chunks = (n_stage + kOneRound - 1) / kOneRound;
  const int rounds = (n_lags + kOneRound - 1) / kOneRound;

  // chunk ch: local samples [ch kOneRound, (ch + 1) kOneRound), one commit
  // group (empty past the last chunk, so the group count stays uniform)
  auto stage = [&](int ch) {
    const int end = min(n_stage, (ch + 1) * kOneRound);
    for (int n = ch * kOneRound + static_cast<int>(threadIdx.x); n < end;
         n += kOneThreads) {
      const long long s = static_cast<long long>(base) + n;
      const bool inside = s < t;
      const float* p = row + (inside ? s : 0) * elem_stride;
      const int bytes = inside ? 4 : 0;
      cp_async_f32(s_re + padded_index(n), p, bytes);
      cp_async_f32(s_im + padded_index(n), p + plane_stride, bytes);
    }
    cp_async_commit();
  };
  for (int ch = 0; ch < kOneAhead; ++ch) stage(ch);

  // taps past K are zero and never used (tap_group's n stops at K)
  float* wr = reinterpret_cast<float*>(s_wr);
  float* wi = reinterpret_cast<float*>(s_wi);
  for (int j = threadIdx.x; j < kTapSlots; j += kOneThreads) {
    const float2 w = j < k ? tpl[j] : make_float2(0.f, 0.f);
    wr[j] = w.x;
    wi[j] = w.y;
  }

  // round rho: each thread one group of L lags, kernel 1's loop; it reads
  // chunks rho and rho + 1 (K <= kOneRound)
  unsigned long long best = 0ull;
  for (int rho = 0; rho < rounds; ++rho) {
    stage(rho + kOneAhead);
    cp_async_wait<kOneAhead - 1>();           // chunks 0 .. rho + 1 have landed
    __syncthreads();
    const int first = rho * kOneRound + static_cast<int>(threadIdx.x) * L;
    if (first < n_lags) {
      const float* pr = s_re + padded_index(first);
      const float* pi = s_im + padded_index(first);
      float xr[L], xi[L], cr[L], ci[L];
#pragma unroll
      for (int q = 0; q < L; ++q) {
        xr[q] = pr[q];
        xi[q] = pi[q];
        cr[q] = 0.f;
        ci[q] = 0.f;
      }
      int j0 = 0;
      for (; j0 + L <= k; j0 += L, pr += L + 1, pi += L + 1) {
        tap_group<kRealTemplate>(pr, pi, s_wr, s_wi, j0, L, xr, xi, cr, ci);
      }
      if (j0 < k) tap_group<kRealTemplate>(pr, pi, s_wr, s_wi, j0, k - j0, xr, xi, cr, ci);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (first + i < n_lags) {
          best = umax64(best, pack_key(fmaf(cr[i], cr[i], ci[i] * ci[i]),
                                       base + first + i));
        }
      }
    }
  }
  for (int ch = rounds + kOneAhead; ch < n_chunks; ++ch) stage(ch);
  cp_async_wait<0>();
  // block_max's barrier also makes every staged sample visible to the block
  best = block_max<kOneThreads>(best, s_warp);
  if (threadIdx.x == 0) s_key = best;
  cluster_arrive();
  cluster_wait();                               // every CTA's key is published
  if (threadIdx.x == 0) {
    unsigned long long m = 0ull;
    for (int q = 0; q < n_cta; ++q) m = umax64(m, *cluster.map_shared_rank(&s_key, q));
    const unsigned lag = 0xFFFFFFFFu - static_cast<unsigned>(m & 0xFFFFFFFFull);
    const int raw = static_cast<int>(lag) - 1;
    if (c == 0) raw_off[r] = raw;
    s_off = min(max(raw, 0), max_off);
  }
  __syncthreads();
  cluster_arrive();                             // done with the other CTAs' keys

  // outputs i < n_out of this CTA read its local sample off + i
  const int off = s_off;
  float* dst = out + r * out_row + static_cast<long long>(base) * out_elem;
  auto aligned = [](const float* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  int done = 0;
  if (out_elem == 1 && aligned(dst) && aligned(dst + out_plane)) {
    // planes: 4 outputs of each plane a float4
    const int quads = n_out / 4;
    for (int q = threadIdx.x; q < quads; q += kOneThreads) {
      const int n = off + 4 * q;
      reinterpret_cast<float4*>(dst)[q] = make_float4(
          s_re[padded_index(n)], s_re[padded_index(n + 1)],
          s_re[padded_index(n + 2)], s_re[padded_index(n + 3)]);
      reinterpret_cast<float4*>(dst + out_plane)[q] = make_float4(
          s_im[padded_index(n)], s_im[padded_index(n + 1)],
          s_im[padded_index(n + 2)], s_im[padded_index(n + 3)]);
    }
    done = 4 * quads;
  } else if (out_elem == 2 && out_plane == 1 && aligned(dst)) {
    // complex64: 2 outputs a float4
    const int pairs = n_out / 2;
    for (int q = threadIdx.x; q < pairs; q += kOneThreads) {
      const int n = off + 2 * q;
      reinterpret_cast<float4*>(dst)[q] = make_float4(
          s_re[padded_index(n)], s_im[padded_index(n)],
          s_re[padded_index(n + 1)], s_im[padded_index(n + 1)]);
    }
    done = 2 * pairs;
  }
  for (int i = done + static_cast<int>(threadIdx.x); i < n_out; i += kOneThreads) {
    dst[i * out_elem] = s_re[padded_index(off + i)];
    dst[out_plane + i * out_elem] = s_im[padded_index(off + i)];
  }
  cluster_wait();                 // no CTA leaves while another reads its key
}

template <typename Kernel>
cudaError_t prepare_one_pass(Kernel* fn) {
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kOneMaxShared);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kRealTemplate>
cudaError_t launch_one_pass(const float* src, long long row_stride,
                            long long plane_stride, long long elem_stride,
                            int rows, int t, const float2* tpl, int k,
                            int lag_bound, int need, int max_off, int cluster,
                            int* raw_off, float* out, long long out_row,
                            long long out_plane, long long out_elem,
                            cudaStream_t s) {
  const int share = one_pass_share(lag_bound, need, cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
  cfg.blockDim = dim3(kOneThreads);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * one_pass_plane(share, k, max_off);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sync_window_kernel<kRealTemplate>, src,
                            row_stride, plane_stride, elem_stride, t, tpl, k,
                            lag_bound, need, max_off, share, raw_off, out,
                            out_row, out_plane, out_elem);
}

__global__ void __launch_bounds__(kThreads)
planar_align_kernel(const float* __restrict__ in, long long row_stride,
                    long long plane_stride, long long elem_stride, long long t,
                    const int* __restrict__ offsets, int need,
                    float* __restrict__ out, long long out_row,
                    long long out_plane, long long out_elem) {
  const int r = blockIdx.x;
  copy_window(in + static_cast<long long>(r) * row_stride, plane_stride,
              elem_stride, offsets[r], t, out + static_cast<long long>(r) * out_row,
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
    corr_argmax_kernel<true><<<g1, kCorrThreads, 0, s>>>(
        src, row_stride, plane_stride, elem_stride, t,
        static_cast<const float2*>(tpl), k, lag_bound, keys);
  } else {
    corr_argmax_kernel<false><<<g1, kCorrThreads, 0, s>>>(
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
      src, row_stride, plane_stride, elem_stride, t, keys, n_partial, max_off,
      need, static_cast<int*>(raw_off), static_cast<float*>(out), out_row,
      out_plane, out_elem);
  return cudaGetLastError();
}

// Dynamic shared memory, in bytes, that one CTA of ofdm_sync_align_one_pass
// takes for these shapes and cluster size (kernels/align.py mirrors it).
extern "C" int ofdm_sync_align_one_pass_shared_bytes(int lag_bound, int need,
                                                     int k, int max_off,
                                                     int cluster) {
  return 2 * static_cast<int>(sizeof(float)) *
         one_pass_plane(one_pass_share(lag_bound, need, cluster), k, max_off);
}

// Let the one-pass kernel take up to kOneMaxShared bytes of dynamic shared
// memory, and prefer shared memory over L1, on the current device.  Call
// once per device before the first launch there, outside any graph capture.
extern "C" int ofdm_sync_align_one_pass_prepare() {
  cudaError_t e = prepare_one_pass(sync_window_kernel<true>);
  return e != cudaSuccess ? e : prepare_one_pass(sync_window_kernel<false>);
}

// K1 in one kernel: the arguments of ofdm_sync_align, with `cluster` CTAs a
// row (1 to 8) in place of the partial keys.  Refuses shapes whose CTA
// would take more than kOneMaxShared bytes of shared memory.
extern "C" int ofdm_sync_align_one_pass(
    const void* in, long long row_stride, long long plane_stride,
    long long elem_stride, int rows, int t, const void* tpl, int k,
    int real_template, int lag_bound, int need, int max_off, int cluster,
    void* raw_off, void* out, long long out_row, long long out_plane,
    long long out_elem, void* stream) {
  if (rows <= 0 || t <= 0 || k <= 0 || k > kMaxTaps || lag_bound <= 0 ||
      lag_bound > t || need <= 0 || need > t || max_off < 0 ||
      max_off > t - need || cluster < 1 || cluster > kOneMaxCluster ||
      rows > INT_MAX / cluster ||
      ofdm_sync_align_one_pass_shared_bytes(lag_bound, need, k, max_off,
                                            cluster) > kOneMaxShared) {
    return cudaErrorInvalidValue;
  }
  const auto* src = static_cast<const float*>(in);
  const auto* w = static_cast<const float2*>(tpl);
  auto* raw = static_cast<int*>(raw_off);
  auto* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (real_template) {
    return launch_one_pass<true>(src, row_stride, plane_stride, elem_stride,
                                 rows, t, w, k, lag_bound, need, max_off,
                                 cluster, raw, dst, out_row, out_plane,
                                 out_elem, s);
  }
  return launch_one_pass<false>(src, row_stride, plane_stride, elem_stride,
                                rows, t, w, k, lag_bound, need, max_off,
                                cluster, raw, dst, out_row, out_plane, out_elem,
                                s);
}

// K3: row r of `out` gets `need` samples of row r of `in` (of the one
// stream when row_stride is 0) from offsets[r] (int32, trusted to be >= 0),
// 0 at and past sample t.  Strides are in floats.
extern "C" int ofdm_planar_align(const void* in, long long row_stride,
                                 long long plane_stride, long long elem_stride,
                                 int rows, long long t, const void* offsets,
                                 int need, void* out, long long out_row,
                                 long long out_plane, long long out_elem,
                                 void* stream) {
  if (rows <= 0 || t <= 0 || need <= 0) return cudaErrorInvalidValue;
  const int n_copy = (need + kCopyPerBlock - 1) / kCopyPerBlock;
  if (n_copy > 65535) return cudaErrorInvalidValue;
  planar_align_kernel<<<dim3(rows, n_copy), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), row_stride, plane_stride, elem_stride, t,
      static_cast<const int*>(offsets), need, static_cast<float*>(out),
      out_row, out_plane, out_elem);
  return cudaGetLastError();
}

// Time-sharded sync (no TPU kernel: it replaces the XLA correlation and
// argmax of ofdm_tpu/parallel/timeshard.py:135-147): kernel 1, then one
// block per row reduces that row's partial keys to its packed key, written
// as one uint64 per row.  No window is copied.  A rank turns the key's lag
// into a global lag and takes the max over its time group, so the packed
// (power bits, 0xFFFFFFFF - lag) order breaks ties to the lowest global lag.
namespace {

__global__ void __launch_bounds__(kThreads)
row_key_kernel(const unsigned long long* __restrict__ partial, int n_partial,
               unsigned long long* __restrict__ keys) {
  __shared__ unsigned long long s_warp[kThreads / 32];
  const unsigned long long* row = partial + static_cast<long long>(blockIdx.x) * n_partial;
  unsigned long long best = 0ull;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) best = umax64(best, row[i]);
  best = block_max<kThreads>(best, s_warp);
  if (threadIdx.x == 0) keys[blockIdx.x] = best;
}

}  // namespace

// `partial` holds rows * ofdm_sync_align_n_partial(lag_bound) uint64 of
// scratch, `keys` rows uint64.  Strides are in floats.
extern "C" int ofdm_sync_keys(const void* in, long long row_stride,
                              long long plane_stride, long long elem_stride,
                              int rows, int t, const void* tpl, int k,
                              int real_template, int lag_bound, void* partial,
                              void* keys, void* stream) {
  if (rows <= 0 || t <= 0 || k <= 0 || k > kMaxTaps || lag_bound <= 0 ||
      lag_bound > t) {
    return cudaErrorInvalidValue;
  }
  const int n_partial = ofdm_sync_align_n_partial(lag_bound);
  if (n_partial > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<unsigned long long*>(partial);
  cudaError_t e = launch_corr(static_cast<const float*>(in), row_stride,
                              plane_stride, elem_stride, rows, t, tpl, k,
                              real_template, lag_bound, n_partial, part, s);
  if (e != cudaSuccess) return e;
  row_key_kernel<<<rows, kThreads, 0, s>>>(part, n_partial,
                                          static_cast<unsigned long long*>(keys));
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
