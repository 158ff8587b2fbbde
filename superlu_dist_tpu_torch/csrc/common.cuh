// Shared helpers of the port's CUDA kernels (cp.async copies and the
// FP64 tensor-core product are used by K1 and K3; the complex type by
// the complex lanes of all three; the bfloat16 conversions by the
// bfloat16 lanes of all three).  Each kernel source is
// built into its own shared library with a plain C interface (see
// superlu_dist_tpu_torch/ops/_cuda.py); every library exports
// slu_cuda_errstr so its Python wrapper can name a failed launch.
#pragma once

#include <cuda_bf16.h>
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

// ------------------------------------------------------------ complex

// |x| of a real number
__host__ __device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__host__ __device__ __forceinline__ double tabs(double x) { return fabs(x); }

// A complex number with its own device operators, laid out as torch's
// complex64 / complex128 (real part first; 8- / 16-byte aligned, so an
// element is one 8- / 16-byte load).  The default constructor is
// trivial, so arrays of it may live in shared memory.
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r, R i = R(0)) : re(r), im(i) {}
  // widening (complex64 panels read by a complex128 lane) and
  // narrowing are explicit
  template <typename S>
  __host__ __device__ explicit constexpr cplx(const cplx<S>& o)
      : re(static_cast<R>(o.re)), im(static_cast<R>(o.im)) {}
};

template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator-(cplx<R> a, cplx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator-(cplx<R> a) {
  return {-a.re, -a.im};
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator*(cplx<R> a, cplx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator*(cplx<R> a, R b) {
  return {a.re * b, a.im * b};
}
// Smith's division: no overflow or underflow of |b|^2 on the way
template <typename R>
__host__ __device__ __forceinline__ cplx<R> operator/(cplx<R> a, cplx<R> b) {
  if (tabs(b.re) >= tabs(b.im)) {
    const R r = b.im / b.re, d = b.re + b.im * r;
    return {(a.re + a.im * r) / d, (a.im - a.re * r) / d};
  }
  const R r = b.re / b.im, d = b.im + b.re * r;
  return {(a.re * r + a.im) / d, (a.im * r - a.re) / d};
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R>& operator+=(cplx<R>& a,
                                                       cplx<R> b) {
  return a = a + b;
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R>& operator-=(cplx<R>& a,
                                                       cplx<R> b) {
  return a = a - b;
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R>& operator*=(cplx<R>& a,
                                                       cplx<R> b) {
  return a = a * b;
}
template <typename R>
__host__ __device__ __forceinline__ cplx<R>& operator/=(cplx<R>& a,
                                                       cplx<R> b) {
  return a = a / b;
}
template <typename R>
__host__ __device__ __forceinline__ bool operator==(cplx<R> a, cplx<R> b) {
  return a.re == b.re && a.im == b.im;
}

using c64 = cplx<float>;
using c128 = cplx<double>;

// the real type of a scalar type (the type of |x| and of thresholds)
template <typename T>
struct RealOf {
  using type = T;
};
template <typename R>
struct RealOf<cplx<R>> {
  using type = R;
};
template <typename T>
using real_t = typename RealOf<T>::type;

template <typename T>
struct IsComplex {
  static constexpr bool value = false;
};
template <typename R>
struct IsComplex<cplx<R>> {
  static constexpr bool value = true;
};

// |x| of a complex number: the modulus through hypot (no overflow of
// re^2 + im^2)
__device__ __forceinline__ float tabs(c64 x) { return hypotf(x.re, x.im); }
__device__ __forceinline__ double tabs(c128 x) { return hypot(x.re, x.im); }

// ------------------------------------------------------------ bfloat16

// bfloat16 is a storage type only: its lanes widen each value to float
// as it is read, compute in float, and round once where they store.
// acc_t<T> is the type a lane computes in; widen / narrow<T> convert
// between the two (identities for every other type).
using bf16 = __nv_bfloat16;

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<bf16> {
  using type = float;
};
template <typename T>
using acc_t = typename AccOf<T>::type;

__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T widen(T x) {
  return x;
}

template <typename T>
__device__ __forceinline__ T narrow(acc_t<T> x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// warp shuffles of any scalar type (a complex one moves as two reals)
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl(cplx<R> v, int src) {
  return {__shfl_sync(0xffffffffu, v.re, src),
          __shfl_sync(0xffffffffu, v.im, src)};
}
template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(cplx<R> v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.re, mask),
          __shfl_xor_sync(0xffffffffu, v.im, mask)};
}
