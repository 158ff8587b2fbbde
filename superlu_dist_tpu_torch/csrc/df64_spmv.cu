// Kernel K4: the double-word (df64) ELL residual product.
//
// Replaces no TPU kernel: the reference package computes this lane in
// plain jnp (superlu_dist_tpu/precision/doubleword.py `df64_ell_spmv`,
// reached through ops/spmv.py `ell_spmv_df64` and the fused loop's
// `_resid_berr_df`, ops/batched.py).  It is a kernel here because the
// plain PyTorch form (superlu_dist_tpu_torch/precision/doubleword.py)
// runs about 20 elementwise launches per ELL slot, and because the
// error-free transformations must survive compilation.
//
//     y = A * x,   A (n x n) in padded ELL: row i holds w slots,
//                  column cols[i*w + k], value (vh, vl)[i*w + k];
//                  x, y: (n, R) row-major (hi, lo) fp32 planes.
//
// Per output element: for k = 0 .. w-1 in slot order, the term
// df_mul((vh, vl), (xh, xl)[col]) is added into a (hi, lo) sum that
// starts at (0, 0) with df_add: the plain version's operations in its
// order, so the result is bitwise the plain version's.  Every
// operation is an explicitly rounded intrinsic (__fadd_rn, __fsub_rn,
// __fmul_rn), which nvcc never contracts into an FMA, and the source is
// built with -fmad=false as well (ops/_cuda.py).
//
// What bounds it on an H100: bytes at one right-hand side (the int64
// column plane and the two value planes are read once, 16 bytes a slot,
// against ~44 fp32 operations a slot); at 64 right-hand sides the
// operations (44 per slot and column) and the bytes of x's and y's
// planes come close.  Design: one thread per (row, column) of y,
// columns fastest, so a warp at R >= 32 reads one row's slots once
// (broadcast) and neighbouring columns of x (coalesced).  Nothing is
// kept in shared memory: each slot is used once per column.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// Dekker split with the splitter 2^12 + 1
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// p = fl(a*b) and its exact error e = ((ah*bh - p) + ah*bl + al*bh) + al*bl
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fsub_rn(__fmul_rn(ah, bh), p);
  e = __fadd_rn(e, __fmul_rn(ah, bl));
  e = __fadd_rn(e, __fmul_rn(al, bh));
  e = __fadd_rn(e, __fmul_rn(al, bl));
}

// (xh, xl) * (yh, yl), the xl*yl term dropped
__device__ __forceinline__ void df_mul(float xh, float xl, float yh,
                                       float yl, float& rh, float& rl) {
  float p, e;
  two_prod(xh, yh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(xh, yl), __fmul_rn(xl, yh)));
  quick_two_sum(p, e, rh, rl);
}

// (xh, xl) + (yh, yl), Knuth's accurate addition
__device__ __forceinline__ void df_add(float xh, float xl, float yh,
                                       float yl, float& rh, float& rl) {
  float s1, s2, t1, t2;
  two_sum(xh, yh, s1, s2);
  two_sum(xl, yl, t1, t2);
  s2 = __fadd_rn(s2, t1);
  quick_two_sum(s1, s2, s1, s2);
  s2 = __fadd_rn(s2, t2);
  quick_two_sum(s1, s2, rh, rl);
}

__global__ void __launch_bounds__(NT)
df64_ell(const int64_t* __restrict__ cols, const float* __restrict__ vh,
         const float* __restrict__ vl, const float* __restrict__ xh,
         const float* __restrict__ xl, float* __restrict__ yh,
         float* __restrict__ yl, int64_t n, int w, int64_t R) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= n * R) return;
  const int64_t row = i / R, r = i - row * R;
  const int64_t base = row * w;
  float sh = 0.0f, sl = 0.0f;
  for (int k = 0; k < w; ++k) {
    const int64_t c = cols[base + k] * R + r;
    float th, tl;
    df_mul(vh[base + k], vl[base + k], xh[c], xl[c], th, tl);
    df_add(sh, sl, th, tl, sh, sl);
  }
  yh[i] = sh;
  yl[i] = sl;
}

}  // namespace

// cols (n, w) int64, vh / vl (n, w) float32, xh / xl / yh / yl (n, R)
// float32, all contiguous; every column index in [0, n).
extern "C" int slu_df64_ell_spmv(void* cols, void* vh, void* vl, void* xh,
                                 void* xl, void* yh, void* yl, int64_t n,
                                 int64_t w, int64_t R, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  if (w < 0 || w > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = ceil_div(n * R, NT);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  df64_ell<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cols), static_cast<const float*>(vh),
      static_cast<const float*>(vl), static_cast<const float*>(xh),
      static_cast<const float*>(xl), static_cast<float*>(yh),
      static_cast<float*>(yl), n, static_cast<int>(w), R);
  return static_cast<int>(cudaGetLastError());
}
