// Shared helpers of the port's CUDA kernels (cp.async copies and the
// FP64 tensor-core product are used by K1 and K3).  Each kernel source is
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

// cp.async: asynchronous global -> shared copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (4, 8 or 16) from global to shared memory, of which the
// first `src_bytes` are read and the rest zero-filled (0: all zeros;
// `src` must still be a valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A*B + D on the FP64 tensor cores, one 16x8x8 tile per warp.
// Fragments (g = lane/4, q = lane%4): a0..a3 = A(g, q), A(g+8, q),
// A(g, q+4), A(g+8, q+4); b0, b1 = B(q, g), B(q+4, g); c0, c1 =
// C(g, 2q), C(g, 2q+1); c2, c3 = the same in row g+8.
__device__ __forceinline__ void dmma(double& c0, double& c1, double& c2,
                                     double& c3, double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// The same with depth 16 (m16n8k16): two m16n8k8 products in one
// instruction.  a0..a7 = A(g, q), A(g+8, q), A(g, q+4), A(g+8, q+4),
// A(g, q+8), A(g+8, q+8), A(g, q+12), A(g+8, q+12); b0..b3 = B(q, g),
// B(q+4, g), B(q+8, g), B(q+12, g); c as above.
__device__ __forceinline__ void dmma16(double& c0, double& c1, double& c2,
                                       double& c3, double a0, double a1,
                                       double a2, double a3, double a4,
                                       double a5, double a6, double a7,
                                       double b0, double b1, double b2,
                                       double b3) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(a4), "d"(a5), "d"(a6),
        "d"(a7), "d"(b0), "d"(b1), "d"(b2), "d"(b3));
}
