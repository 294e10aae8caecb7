// Shared by every kernel library of ofdm_tpu_torch: each .cu file is built
// into its own shared library with a plain C interface and loaded with ctypes
// (ofdm_tpu_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

// Message for a cudaError_t returned by a launch function.
extern "C" const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
