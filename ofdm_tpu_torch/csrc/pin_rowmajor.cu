// pin_rowmajor.cu: a row-major copy of a strided tensor.
//
// Replaces the TPU kernel ofdm_tpu/kernels/align_pallas.py::pin_rowmajor, an
// identity Pallas copy whose output buffer is row-major by construction.  On
// the GPU the same need arises when a planar stream arrives as a strided
// view, for example the planes of a complex capture,
// torch.view_as_real(rx).transpose(1, 2) (f32 [R, 2, T] with strides
// (2T, 1, 2)): the decode kernels read contiguous rows, so the view is made
// row-major first.
//
//   out[i0, i1, i2, i3] = in[i0 * s0 + i1 * s1 + i2 * s2 + i3 * s3]
//
// for a 2-D to 4-D tensor (leading sizes of 1 fill the missing dimensions),
// strides in elements, elements of 1, 2, 4 or 8 bytes copied as raw bits.
//
// What bounds it on the H100: bytes.  At the decode path's shape (f32
// [256, 2, 19,120], ~39 MB read and ~39 MB written) ~23 us at 3.35 TB/s.
// The writes are contiguous; the reads of the transposed view are 8 bytes
// apart between neighbouring threads, so half of each read sector is the
// other plane's, which the other plane's blocks read again (mostly from L2).
//
// Design: grid (outer index, inner chunks).  A block takes one index of the
// leading dimensions, computes its source offset once, and copies up to
// kPerBlock elements of the innermost dimension, so the inner loop has no
// division.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

struct Dims {
  long long size[4];
  long long stride[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowmajor_copy_kernel(const T* __restrict__ in, Dims d, T* __restrict__ out) {
  const long long outer = blockIdx.x;              // over dims 0..2, row-major
  const long long i2 = outer % d.size[2];
  const long long i1 = (outer / d.size[2]) % d.size[1];
  const long long i0 = outer / (d.size[2] * d.size[1]);
  const T* src = in + i0 * d.stride[0] + i1 * d.stride[1] + i2 * d.stride[2];
  T* dst = out + outer * d.size[3];
  const long long begin = static_cast<long long>(blockIdx.y) * kPerBlock;
  const long long end = min(d.size[3], begin + kPerBlock);
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    dst[j] = src[j * d.stride[3]];
  }
}

template <typename T>
int launch(const void* in, const Dims& d, void* out, cudaStream_t s) {
  const long long outer = d.size[0] * d.size[1] * d.size[2];
  const long long n_inner = (d.size[3] + kPerBlock - 1) / kPerBlock;
  if (outer > 0x7FFFFFFFll || n_inner > 65535) return cudaErrorInvalidValue;
  rowmajor_copy_kernel<T><<<dim3(static_cast<unsigned>(outer),
                                 static_cast<unsigned>(n_inner)),
                            kThreads, 0, s>>>(static_cast<const T*>(in), d,
                                              static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// sizes/strides: 4 each (elements), the tensor's dims right-aligned with
// leading sizes of 1.  itemsize: 1, 2, 4 or 8 bytes.  `out` holds
// prod(sizes) elements, row-major.  Returns a cudaError_t (0 on success).
extern "C" int ofdm_pin_rowmajor(const void* in, const long long* sizes,
                                 const long long* strides, int itemsize,
                                 void* out, void* stream) {
  Dims d;
  for (int i = 0; i < 4; ++i) {
    if (sizes[i] <= 0) return cudaErrorInvalidValue;
    d.size[i] = sizes[i];
    d.stride[i] = strides[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(in, d, out, s);
    case 2: return launch<uint16_t>(in, d, out, s);
    case 4: return launch<uint32_t>(in, d, out, s);
    case 8: return launch<unsigned long long>(in, d, out, s);
    default: return cudaErrorInvalidValue;
  }
}
