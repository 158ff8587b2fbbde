// Shared helpers of the port's CUDA kernels.  Each kernel source is
// built into its own shared library with a plain C interface (see
// superlu_dist_tpu_torch/ops/_cuda.py); every library exports
// slu_cuda_errstr so its Python wrapper can name a failed launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* slu_cuda_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a,
                                                     int64_t b) {
  return (a + b - 1) / b;
}
