// Kernel K1: batched partial LU of the fronts of one group, in place.
//
// Replaces the Pallas kernel of the reference package,
// superlu_dist_tpu/ops/pallas_lu.py (`_pallas_lu_call`, bodies
// `_lu_kernel_blocked` and `_lu_kernel`, wrapper
// `partial_lu_batch_pallas`).  Computes, for each front F (mb x mb) of a
// batch of N, the partial LU without pivoting of its leading wb columns:
// unit L below the diagonal, U on and above it, the Schur complement in
// F[wb:, wb:].  GESP tiny-pivot replacement sets |piv| < thresh to
// sign(piv)*thresh; per-front counts of replaced pivots and of exact
// zeros (thresh == 0) are accumulated into tiny[f] / nzero[f], one
// writer per front at a time.  thresh is read on the device from a
// one-element float64 array, so a captured CUDA graph that launches the
// kernel serves every threshold the host writes there before a replay.
//
// What bounds it on an H100: the trailing update F22 -= L21*U12 holds
// almost all the operations (2*wb*(mb-wb)^2 per front).  Done once at
// depth wb it is operations-bound on the large fronts (FP64 tensor
// cores, 67 TFLOP/s) and bytes-bound on the small ones (each element of
// F read and written once).  A blocked update at a shallow depth, as the
// TPU kernel's large on-chip memory affords, would instead reread and
// rewrite the trailing matrix at every block step.  What remains
// sequential is the chain of wb pivots: it sets the time of the panel
// phase, and every design choice below keeps that chain short.
//
// Design: the regime is chosen on the host (ops/panel_lu.py
// `launch_plan`) and passed in; no fallback.
//   * small (the whole front fits 128 KiB): one launch, `lu_small`.
//     mb <= 32: one warp per front (8 fronts per CTA), the front in
//     registers, a column a lane, every step by shuffles (warp_lu32).
//     Otherwise one CTA per front: the cross of the front -- the panel
//     F[:, :wb] and the strip F[:wb, wb:], the whole front when wb ==
//     mb -- is loaded once into shared memory (16-byte copies where rows
//     are aligned), its top wb rows eliminated by rank-1 steps with the
//     GESP step and the counters, the rows below solved against U11, and
//     stored once; then F22 is read once, reduced by the depth-wb
//     product of the cross (4 x 4 register blocks) and written once.
//   * large: panel blocks of 64 columns, nblk of them; nblk + 1 launches
//     of `panel_step`, then `panel_copy`, `strip_solve` and one
//     `schur_update`:
//       - `panel_step` j: a CTA per (64-row tile, 64-column block) of
//         the panel; it forms its rows of L for block j-1 and U's block
//         as products with the inverses of block j-1's diagonal block
//         and updates its own tile; the CTA of block j's diagonal then
//         factors it with GESP and counters and inverts its triangles
//         (two 32 x 32 warp factorizations, warp solves and small
//         products; in a busy launch, whose head shares its SM, the
//         all-warps factor_diag / invert_diag).  L and U go to a
//         workspace, so no launch writes what another CTA of it reads;
//       - `panel_copy` moves them into F;
//       - `strip_solve`: U12 = inv(L11) F12, left-looking, one CTA per 64
//         columns of the strip;
//       - `schur_update`: F22 -= L21*U12 once at depth wb, 128 x 128
//         output tiles over a 3-stage cp.async ring.
//     The products run in float64 on the FP64 tensor cores (mma.sync
//     m16n8k16), in float32 on FMA with register blocks (never TF32).
// Complex lanes (complex64 / complex128, the complex type of common.cuh):
// the same kernels in complex arithmetic.  GESP keeps the pivot's phase
// (piv/|piv|*thresh, thresh for an exact zero; |piv| through hypot), the
// counters are the real lanes'.  Every product, the trailing update
// included, is complex FMAs on the CUDA cores with register blocks (the
// FP64 mma takes no complex operands); schur_update uses 64 x 64 output
// tiles at depth 16 there, so that its ring fits shared memory and a
// thread's complex sums stay in registers.
// bfloat16 lane (a bfloat16 factorization): bfloat16 storage, float32
// arithmetic.  The fronts are widened into a float32 copy, the float32
// lane factors it (its regime and workspace), and each element is
// rounded once back into F: the class the TPU kernel computed in (f32
// accumulation on the MXU), at three extra passes over the fronts.
// Edge tiles are predicated; the batch is chunked at the 65535 limit of
// gridDim.y / gridDim.z.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per CTA in every kernel
constexpr int PB = 64;         // panel block depth (large regime)
constexpr int RT = 64;         // rows per panel / strip tile
constexpr int CT = 64;         // columns per panel-update / strip tile
constexpr int WARP_MB = 32;    // small fronts up to this: a warp each
// schur_update's tile: BM x BN outputs, depth BK per stage, ST stages
template <typename T>
struct Upd {
  static constexpr int BM = 128, BN = 128, BK = 32, ST = 3;
};
template <typename R>
struct Upd<cplx<R>> {
  static constexpr int BM = 64, BN = 64, BK = 16, ST = 3;
};

// shared-memory row strides (elements): 64-bit fragment reads of the
// tensor-core path fall in distinct bank pairs with a +4 (A) / +8 (B)
// pad; the factor blocks use +1 (column walks)
constexpr int LDL = PB + 4;    // L tile (A operand), RT x LDL
constexpr int LDB = CT + 8;    // B operand, PB x LDB
constexpr int LDD = PB + 1;    // diagonal block, PB x LDD

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<c128> {
  using type = double2;
};
template <>
struct Vec16<c64> {
  using type = float4;
};

// GESP tiny-pivot replacement of one pivot (dense_lu._tiny_replace): a
// real pivot becomes sign(piv)*thresh, a complex one piv/|piv|*thresh
// (thresh where it is exactly zero)
template <typename T>
__device__ __forceinline__ T gesp(T piv, real_t<T> thresh, int& ltiny,
                                  int& lzero) {
  using R = real_t<T>;
  const R apiv = tabs(piv);
  const bool is_tiny = apiv < thresh;
  ltiny += is_tiny ? 1 : 0;
  lzero += (apiv == R(0) && !is_tiny) ? 1 : 0;
  if (!is_tiny) return piv;
  if constexpr (IsComplex<T>::value) {
    if (apiv == R(0)) return T(thresh);
    return T(piv.re / apiv, piv.im / apiv) * thresh;
  } else {
    return piv >= T(0) ? thresh : -thresh;
  }
}

// ------------------------------------------------------- tile products

// acc += A*B over a BM x BN tile on the FP64 tensor cores (m16n8k16 steps,
// an m16n8k8 step for a remainder of 8): A (BM x kd)
// row-major in shared memory (stride lda), B (kd x BN) row-major
// (stride ldb), kd a multiple of 8 (callers zero-pad).  Warps WM x WN,
// each an (FM*8) x (FN*8) block of 8x8 fragments, two per product.
template <int BM, int BN, int WM, int WN>
struct MmaTile {
  static_assert(WM * WN * 32 == NT, "one warp per sub-tile");
  static constexpr int FM = BM / WM / 8, FN = BN / WN / 8;
  static_assert(FM % 2 == 0, "m16n8k8 tiling");
  double acc[FM][FN][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  }

  __device__ __forceinline__ void step(const double* __restrict__ As,
                                       int lda,
                                       const double* __restrict__ Bs,
                                       int ldb, int kd) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp / WN) * (FM * 8), c0 = (warp % WN) * (FN * 8);
    int k = 0;
    for (; k + 16 <= kd; k += 16) {
      double a[FM][4], b[FN][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          a[i][h] = As[(r0 + i * 8 + g) * lda + k + q + 4 * h];
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          b[j][h] = Bs[(k + q + 4 * h) * ldb + c0 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < FM; i += 2)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          dmma16(acc[i][j][0], acc[i][j][1], acc[i + 1][j][0],
                 acc[i + 1][j][1], a[i][0], a[i + 1][0], a[i][1],
                 a[i + 1][1], a[i][2], a[i + 1][2], a[i][3], a[i + 1][3],
                 b[j][0], b[j][1], b[j][2], b[j][3]);
    }
    for (; k < kd; k += 8) {
      double a[FM][2], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][h] = As[(r0 + i * 8 + g) * lda + k + q + 4 * h];
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[j][h] = Bs[(k + q + 4 * h) * ldb + c0 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < FM; i += 2)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          dmma(acc[i][j][0], acc[i][j][1], acc[i + 1][j][0],
               acc[i + 1][j][1], a[i][0], a[i + 1][0], a[i][1],
               a[i + 1][1], b[j][0], b[j][1]);
    }
  }

  // out(row, col, value) for every row < nrows, col < ncols of the tile
  template <typename Out>
  __device__ __forceinline__ void store(int nrows, int ncols, Out out) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp / WN) * (FM * 8), c0 = (warp % WN) * (FN * 8);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + i * 8 + g, c = c0 + j * 8 + 2 * q + h;
          if (r < nrows && c < ncols) out(r, c, acc[i][j][h]);
        }
  }

  // C -= acc in global memory (row stride ldc): each fragment row's
  // values are all loaded before any is stored, so the loads overlap
  __device__ __forceinline__ void rmw(double* __restrict__ C, int64_t ldc,
                                      int nrows, int ncols) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp / WN) * (FM * 8), c0 = (warp % WN) * (FN * 8);
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int r = r0 + i * 8 + g;
      double cv[FN][2];
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + j * 8 + 2 * q + h;
          cv[j][h] = (r < nrows && c < ncols) ? C[r * ldc + c] : 0.0;
        }
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + j * 8 + 2 * q + h;
          if (r < nrows && c < ncols) C[r * ldc + c] = cv[j][h] - acc[i][j][h];
        }
    }
  }
};

// The same contract on FMA: a 16 x 16 thread grid, thread (ty, tx)
// holding rows ty + 16*i and columns tx + 16*j (i < BM/16, j < BN/16),
// so neighbouring threads read neighbouring B values and store
// neighbouring columns.
template <typename T, int BM, int BN>
struct FmaTile {
  static constexpr int TM = BM / 16, TN = BN / 16;
  T acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  }

  __device__ __forceinline__ void step(const T* __restrict__ As, int lda,
                                       const T* __restrict__ Bs, int ldb,
                                       int kd) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int k = 0; k < kd; ++k) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
  }

  template <typename Out>
  __device__ __forceinline__ void store(int nrows, int ncols, Out out) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (r < nrows && c < ncols) out(r, c, acc[i][j]);
      }
  }

  __device__ __forceinline__ void rmw(T* __restrict__ C, int64_t ldc,
                                      int nrows, int ncols) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      T cv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        cv[j] = (r < nrows && c < ncols) ? C[r * ldc + c] : T(0);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        if (r < nrows && c < ncols) C[r * ldc + c] = cv[j] - acc[i][j];
      }
    }
  }
};

// float64 on the tensor cores, float32 on FMA
template <typename T, int BM, int BN>
using Tile = typename std::conditional<
    std::is_same<T, double>::value,
    MmaTile<BM, BN, (BM >= 128 ? 4 : 2), (BM >= 128 ? 2 : 4)>,
    FmaTile<T, BM, BN>>::type;

// Copy a rows x cols block of a row-major global matrix (stride ld) into
// shared memory (stride lds) with element-wise cp.async, zero-filling up
// to ROWS x COLS, and wait for it (the caller syncs the CTA).
template <typename T>
__device__ __forceinline__ void load_block(T* __restrict__ dst, int lds,
                                           const T* __restrict__ src,
                                           int64_t ld, int rows, int cols,
                                           int ROWS, int COLS) {
  constexpr int B = static_cast<int>(sizeof(T));
  for (int r = threadIdx.x / 32; r < ROWS; r += NT / 32)
    for (int c = threadIdx.x % 32; c < COLS; c += 32) {
      const bool ok = r < rows && c < cols;
      cp_async<B>(dst + r * lds + c, ok ? src + r * ld + c : src,
                  ok ? B : 0);
    }
  cp_commit();
  cp_wait<0>();
}

// ------------------------------------------------- diagonal blocks

// One warp eliminates the first nsteps columns of the n x n (n <= 32)
// block D (stride ld; shared or global memory) in place by rank-1 steps
// with GESP replacement -- a full LU when nsteps == n, the partial LU of
// a small front otherwise -- lane j holding column j in registers: the
// pivot and each multiplier reach the other lanes by shuffles, so a step
// costs no barrier.  The pivot column is scaled by the pivot's
// reciprocal, which goes to rd[t] unless rd is null.  Lane 0 counts.
template <typename T>
__device__ __forceinline__ void warp_lu32(T* __restrict__ D, int ld, int n,
                                          int nsteps, real_t<T> thresh,
                                          T* __restrict__ rd, int& ltiny,
                                          int& lzero) {
  const int lane = threadIdx.x % 32;
  T a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    a[i] = (i < n && lane < n) ? D[i * ld + lane] : T(0);
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (t < nsteps) {
      const T piv = gesp(shfl(a[t], t), thresh, ltiny, lzero);
      const T r = T(1) / piv;
      if (lane == t) {
        a[t] = piv;
#pragma unroll
        for (int i = t + 1; i < 32; ++i) a[i] *= r;
      }
      if (rd != nullptr && lane == 0) rd[t] = r;
#pragma unroll
      for (int i = t + 1; i < 32; ++i) {
        const T l = shfl(a[i], t);
        if (lane > t) a[i] -= l * a[t];
      }
    }
  }
  if (lane < n) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < n) D[i * ld + lane] = a[i];
  }
}

// One warp: X (n rows x m <= 32 columns, stride ldx) <- inv(L) * X, L the
// unit lower triangle of the n x n (n <= 32) block at L (stride ld);
// lane j holds column j.
template <typename T>
__device__ __forceinline__ void warp_trsm_lower32(const T* __restrict__ L,
                                                  int ld, int n,
                                                  T* __restrict__ X,
                                                  int ldx, int m) {
  const int lane = threadIdx.x % 32;
  T x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    x[i] = (i < n && lane < m) ? X[i * ldx + lane] : T(0);
#pragma unroll
  for (int i = 1; i < 32; ++i)
    if (i < n) {
      T s0 = 0, s1 = 0;
#pragma unroll
      for (int k = 0; k < i; ++k) {
        if (k & 1)
          s1 += L[i * ld + k] * x[k];
        else
          s0 += L[i * ld + k] * x[k];
      }
      x[i] -= s0 + s1;
    }
  if (lane < m) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < n) X[i * ldx + lane] = x[i];
  }
}

// One warp: X (m <= 32 rows x n columns, stride ldx) <- X * inv(U), U the
// upper triangle of the n x n (n <= 32) block at U (stride ld), rd its
// diagonal's reciprocals; lane i holds row i.
template <typename T>
__device__ __forceinline__ void warp_trsm_upper32(const T* __restrict__ U,
                                                  int ld, int n,
                                                  const T* __restrict__ rd,
                                                  T* __restrict__ X,
                                                  int ldx, int m) {
  const int lane = threadIdx.x % 32;
  T x[32];
#pragma unroll
  for (int c = 0; c < 32; ++c)
    x[c] = (c < n && lane < m) ? X[lane * ldx + c] : T(0);
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c < n) {
      T s0 = 0, s1 = 0;
#pragma unroll
      for (int k = 0; k < c; ++k) {
        if (k & 1)
          s1 += x[k] * U[k * ld + c];
        else
          s0 += x[k] * U[k * ld + c];
      }
      x[c] = (x[c] - (s0 + s1)) * rd[c];
    }
  if (lane < m) {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (c < n) X[lane * ldx + c] = x[c];
  }
}

// One warp: X (32 x 32, stride ldx) <- inv(unit lower L) (lower == true)
// or inv(U) (lower == false, rd the reciprocals of U's diagonal) of the
// n x n (n <= 32) block at A (stride ld); lane j computes column j.
// Entries past n are left zero.
template <typename T, bool LOWER>
__device__ __forceinline__ void warp_inv32(const T* __restrict__ A, int ld,
                                           int n, const T* __restrict__ rd,
                                           T* __restrict__ X, int ldx) {
  const int j = threadIdx.x % 32;
  T x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = T(0);
  if constexpr (LOWER) {
    // x_j = 1, x_i = -sum_{k<i} L_ik x_k (x_k = 0 for k < j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < n) {
        T s0 = 0, s1 = 0;
#pragma unroll
        for (int k = 0; k < i; ++k) {
          if (k & 1)
            s1 += A[i * ld + k] * x[k];
          else
            s0 += A[i * ld + k] * x[k];
        }
        x[i] = (i == j) ? T(1) : -(s0 + s1);
      }
    }
  } else {
    // backward: x_i = (delta_ij - sum_{k>i} U_ik x_k) / U_ii
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      if (i < n) {
        T s0 = 0, s1 = 0;
#pragma unroll
        for (int k = i + 1; k < 32; ++k) {
          if (k < n) {
            if (k & 1)
              s1 += A[i * ld + k] * x[k];
            else
              s0 += A[i * ld + k] * x[k];
          }
        }
        x[i] = ((i == j ? T(1) : T(0)) - (s0 + s1)) * rd[i];
      }
    }
  }
  if (j < n) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < n) X[i * ldx + j] = x[i];
  }
}

// C (32 x 32, stride ldc) = sign * A (32 x 32) * B (32 x 32), all in
// shared memory, by 128 threads (tid < 128), eight outputs each.
template <typename T>
__device__ __forceinline__ void small_gemm32(const T* __restrict__ A,
                                             int lda,
                                             const T* __restrict__ B,
                                             int ldb, T* __restrict__ C,
                                             int ldc, T sign, int tid) {
  const int c = tid % 32, r0 = (tid / 32) * 8;
  T acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = T(0);
  for (int k = 0; k < 32; ++k) {
    const T b = B[k * ldb + c];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] += A[(r0 + u) * lda + k] * b;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) C[(r0 + u) * ldc + c] = sign * acc[u];
}

// Factor the kb x kb (kb <= PB = 64) diagonal block D (stride LDD) in
// place with GESP replacement, and form Li = inv(unit lower L) and Ui =
// inv(U) (PB x PB, stride LDL, zero past kb), as 32 x 32 blocks: warp 0
// factors D11; warps 0 and 1 solve U12 = inv(L11) D12 and L21 = D21
// inv(U11) side by side; all threads update D22 -= L21 U12; warp 0
// factors D22; warps 0-3 invert the four triangles side by side; the
// off-diagonal blocks of the inverses come from two 32 x 32 products
// each.  Only the factorizations of D11 and D22 are sequential steps,
// and they cost no barrier.  Thread 0 ends with the counts.
template <typename T>
__device__ __forceinline__ void factor_invert(T* __restrict__ D, int kb,
                                              real_t<T> thresh,
                                              T* __restrict__ Li,
                                              T* __restrict__ Ui,
                                              int& ltiny, int& lzero) {
  __shared__ T rd[PB];
  const int warp = threadIdx.x / 32;
  const int n0 = min(kb, 32), n1 = kb - n0;
  for (int r = threadIdx.x / 32; r < PB; r += NT / 32)
    for (int c = threadIdx.x % 32; c < PB; c += 32) {
      Li[r * LDL + c] = T(0);
      Ui[r * LDL + c] = T(0);
    }
  if (warp == 0) warp_lu32(D, LDD, n0, n0, thresh, rd, ltiny, lzero);
  __syncthreads();
  if (n1 > 0) {
    if (warp == 0)
      warp_trsm_lower32(D, LDD, 32, D + 32, LDD, n1);
    else if (warp == 1)
      warp_trsm_upper32(D, LDD, 32, rd, D + 32 * LDD, LDD, n1);
    __syncthreads();
    // D22 -= L21 * U12
    for (int idx = threadIdx.x; idx < n1 * n1; idx += NT) {
      const int r = 32 + idx / n1, c = 32 + idx % n1;
      T s0 = 0, s1 = 0;
#pragma unroll 8
      for (int k = 0; k < 32; k += 2) {
        s0 += D[r * LDD + k] * D[k * LDD + c];
        s1 += D[r * LDD + k + 1] * D[(k + 1) * LDD + c];
      }
      D[r * LDD + c] -= s0 + s1;
    }
    __syncthreads();
    if (warp == 0)
      warp_lu32(D + 32 * LDD + 32, LDD, n1, n1, thresh, rd + 32, ltiny,
                lzero);
    __syncthreads();
  }
  if (warp == 0)
    warp_inv32<T, true>(D, LDD, n0, nullptr, Li, LDL);
  else if (warp == 1 && n1 > 0)
    warp_inv32<T, true>(D + 32 * LDD + 32, LDD, n1, nullptr,
                        Li + 32 * LDL + 32, LDL);
  else if (warp == 2)
    warp_inv32<T, false>(D, LDD, n0, rd, Ui, LDL);
  else if (warp == 3 && n1 > 0)
    warp_inv32<T, false>(D + 32 * LDD + 32, LDD, n1, rd + 32,
                         Ui + 32 * LDL + 32, LDL);
  __syncthreads();
  if (n1 > 0) {
    // Li21 = -inv(L22) L21 inv(L11); Ui12 = -inv(U11) U12 inv(U22); the
    // middle products go to the blocks that stay zero (Li12, Ui21)
    if (threadIdx.x < 128)
      small_gemm32(D + 32 * LDD, LDD, Li, LDL, Li + 32, LDL, T(1),
                   threadIdx.x);
    else
      small_gemm32(D + 32, LDD, Ui + 32 * LDL + 32, LDL, Ui + 32 * LDL,
                   LDL, T(1), threadIdx.x - 128);
    __syncthreads();
    if (threadIdx.x < 128)
      small_gemm32(Li + 32 * LDL + 32, LDL, Li + 32, LDL, Li + 32 * LDL,
                   LDL, T(-1), threadIdx.x);
    else
      small_gemm32(Ui, LDL, Ui + 32 * LDL, LDL, Ui + 32, LDL, T(-1),
                   threadIdx.x - 128);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 32 * 32; idx += NT) {
      const int r = idx / 32, c = idx % 32;
      Li[r * LDL + 32 + c] = T(0);
      Ui[(32 + r) * LDL + c] = T(0);
    }
    __syncthreads();
  }
}

// The head for a busy launch (more CTAs than SMs, so the head CTA shares
// its SM with CTAs of the bulk): every step spreads over all eight warps,
// which keeps the sequential chain from starving for issue slots.
// factor_diag: rank-1 steps on the kb x kb block D (stride LDD) with
// GESP replacement, two barriers a step (the pivot is written back in
// the update phase, where nobody reads it); every thread ends with the
// counts.  invert_diag: Li = inv(unit lower L) and Ui = inv(U) (PB x PB,
// stride LDL, zero past kb), a thread per column, four partial sums per
// dot product.
template <typename T>
__device__ __forceinline__ void factor_diag(T* __restrict__ D, int kb,
                                            real_t<T> thresh, int& ltiny,
                                            int& lzero) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < kb; ++t) {
    const T newpiv = gesp(D[t * LDD + t], thresh, ltiny, lzero);
    for (int i = t + 1 + threadIdx.x; i < kb; i += NT)
      D[i * LDD + t] /= newpiv;
    __syncthreads();
    if (threadIdx.x == 0) D[t * LDD + t] = newpiv;
    // the pivot row stays in registers (two columns a lane)
    const int j0 = t + 1 + lane, j1 = j0 + 32;
    const T u0 = j0 < kb ? D[t * LDD + j0] : T(0);
    const T u1 = j1 < kb ? D[t * LDD + j1] : T(0);
    for (int i = t + 1 + warp; i < kb; i += NT / 32) {
      const T l = D[i * LDD + t];
      const T v0 = j0 < kb ? D[i * LDD + j0] : T(0);
      const T v1 = j1 < kb ? D[i * LDD + j1] : T(0);
      if (j0 < kb) D[i * LDD + j0] = v0 - l * u0;
      if (j1 < kb) D[i * LDD + j1] = v1 - l * u1;
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void invert_diag(const T* __restrict__ D,
                                            int kb, T* __restrict__ Li,
                                            T* __restrict__ Ui) {
  for (int r = threadIdx.x / 32; r < PB; r += NT / 32)
    for (int c = threadIdx.x % 32; c < PB; c += 32) {
      Li[r * LDL + c] = (r == c && r < kb) ? T(1) : T(0);
      Ui[r * LDL + c] = T(0);
    }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kb) {
    T* x = Li + t;  // column t: x_t = 1, x_i = -sum_{t<=k<i} L_ik x_k
    for (int i = t + 1; i < kb; ++i) {
      T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      int k = t;
      for (; k + 3 < i; k += 4) {
        s0 += D[i * LDD + k] * x[k * LDL];
        s1 += D[i * LDD + k + 1] * x[(k + 1) * LDL];
        s2 += D[i * LDD + k + 2] * x[(k + 2) * LDL];
        s3 += D[i * LDD + k + 3] * x[(k + 3) * LDL];
      }
      for (; k < i; ++k) s0 += D[i * LDD + k] * x[k * LDL];
      x[i * LDL] = -((s0 + s1) + (s2 + s3));
    }
  } else if (t >= 128 && t - 128 < kb) {
    const int c = t - 128;
    T* x = Ui + c;  // column c: x_c = 1/U_cc, x_i = -(sum U_ik x_k)/U_ii
    x[c * LDL] = T(1) / D[c * LDD + c];
    for (int i = c - 1; i >= 0; --i) {
      T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      int k = i + 1;
      for (; k + 3 <= c; k += 4) {
        s0 += D[i * LDD + k] * x[k * LDL];
        s1 += D[i * LDD + k + 1] * x[(k + 1) * LDL];
        s2 += D[i * LDD + k + 2] * x[(k + 2) * LDL];
        s3 += D[i * LDD + k + 3] * x[(k + 3) * LDL];
      }
      for (; k <= c; ++k) s0 += D[i * LDD + k] * x[k * LDL];
      x[i * LDL] = -((s0 + s1) + (s2 + s3)) / D[i * LDD + i];
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- small

// One group of G threads (a warp, or the whole CTA) per front.
template <int G>
__device__ __forceinline__ void gsync() {
  if constexpr (G == 32)
    __syncwarp();
  else
    __syncthreads();
}

// shared-memory row padding of the small kernel's cross: E elements
// (16 bytes) when rows are 16-byte aligned, so whole rows copy as
// 16-byte chunks; else one element
template <typename T>
__host__ __device__ __forceinline__ int small_pad(int mb, int wb) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  return (mb % E == 0 && wb % E == 0) ? E : 1;
}

template <typename T, int G>
__global__ void __launch_bounds__(NT)
lu_small(T* __restrict__ F, int64_t N, int mb, int wb,
         const double* __restrict__ thp, int* __restrict__ tiny,
         int* __restrict__ nzero) {
  const real_t<T> thresh = static_cast<real_t<T>>(*thp);
  using V = typename Vec16<T>::type;
  constexpr int E = 16 / sizeof(T);
  constexpr int NG = NT / G, NW = G / 32;
  // columns per lane in the elimination: mb <= 32 in warp mode, and a
  // small front has mb <= 181 (128 KiB of float32)
  constexpr int MAXC = (G == 32) ? 1 : 6;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = threadIdx.x / G, lt = threadIdx.x % G;
  const int w = lt / 32, lane = lt % 32;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * NG + grp;
  // warp mode syncs only its warp, so a warp past the batch may leave
  if (f >= N) return;
  if constexpr (G == 32) {
    // the whole front (mb <= 32) in the warp's registers, a column a lane
    int ltiny = 0, lzero = 0;
    warp_lu32(F + f * mb * mb, mb, mb, wb, thresh, static_cast<T*>(nullptr),
              ltiny, lzero);
    if (lane == 0) {
      tiny[f] += ltiny;
      nzero[f] += lzero;
    }
    return;
  }
  const int rb = mb - wb;
  const int pad = small_pad<T>(mb, wb);
  const bool vec = pad == E;
  const int LP = wb + pad, LS = rb + pad;
  T* P = reinterpret_cast<T*>(smem_raw) +
         static_cast<int64_t>(grp) * (mb * LP + wb * LS);
  T* S = P + mb * LP;
  T* Ff = F + f * mb * mb;
  auto at = [&](int i, int j) {
    return (j < wb) ? P + i * LP + j : S + i * LS + (j - wb);
  };

  // load the cross (panel columns < wb of every row, strip rows < wb):
  // every copy in flight at once
  for (int i = w; i < mb; i += NW) {
    const int ncol = (i < wb) ? mb : wb;
    if (vec) {
      for (int j = lane * E; j < ncol; j += 32 * E)
        cp_async<16>(at(i, j), Ff + i * mb + j, 16);
    } else {
      for (int j = lane; j < ncol; j += 32)
        cp_async<sizeof(T)>(at(i, j), Ff + i * mb + j, sizeof(T));
    }
  }
  cp_commit();
  cp_wait<0>();
  gsync<G>();

  int ltiny = 0, lzero = 0;
  // rank-1 elimination of the top rows (i < wb) of the cross: the
  // diagonal block and the strip; two barriers a step (the pivot is
  // written back in the update phase, where nobody reads it)
  for (int t = 0; t < wb; ++t) {
    const T newpiv = gesp(P[t * LP + t], thresh, ltiny, lzero);
    for (int i = t + 1 + lt; i < wb; i += G) P[i * LP + t] /= newpiv;
    gsync<G>();
    if (lt == 0) P[t * LP + t] = newpiv;
    // the pivot row's values for this lane's columns stay in registers;
    // each row's values are all loaded before any is stored
    const int nq = (mb - t - 1 - lane + 31) / 32;   // columns of this lane
    T u[MAXC];
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q < nq) u[q] = *at(t, t + 1 + lane + 32 * q);
    for (int i = t + 1 + w; i < wb; i += NW) {
      const T l = P[i * LP + t];
      T v[MAXC];
#pragma unroll
      for (int q = 0; q < MAXC; ++q)
        if (q < nq) v[q] = *at(i, t + 1 + lane + 32 * q);
#pragma unroll
      for (int q = 0; q < MAXC; ++q)
        if (q < nq) *at(i, t + 1 + lane + 32 * q) = v[q] - l * u[q];
    }
    gsync<G>();
  }
  // the rows below (i >= wb) of L: x * U11 = a, one thread per row, in
  // place, four partial sums per dot product
  for (int i = wb + lt; i < mb; i += G) {
    T* x = P + i * LP;
    for (int c = 0; c < wb; ++c) {
      T s0 = x[c], s1 = 0, s2 = 0, s3 = 0;
      int k = 0;
      for (; k + 3 < c; k += 4) {
        s0 -= x[k] * P[k * LP + c];
        s1 -= x[k + 1] * P[(k + 1) * LP + c];
        s2 -= x[k + 2] * P[(k + 2) * LP + c];
        s3 -= x[k + 3] * P[(k + 3) * LP + c];
      }
      for (; k < c; ++k) s0 -= x[k] * P[k * LP + c];
      x[c] = ((s0 + s1) + (s2 + s3)) / P[c * LP + c];
    }
  }
  gsync<G>();
  if (lt == 0) {
    tiny[f] += ltiny;
    nzero[f] += lzero;
  }

  // store the cross
  for (int i = w; i < mb; i += NW) {
    const int ncol = (i < wb) ? mb : wb;
    if (vec) {
      for (int j = lane * E; j < ncol; j += 32 * E)
        *reinterpret_cast<V*>(Ff + i * mb + j) =
            *reinterpret_cast<const V*>(at(i, j));
    } else {
      for (int j = lane; j < ncol; j += 32) Ff[i * mb + j] = *at(i, j);
    }
  }

  // F22 -= L21 * U12 at depth wb, read and written once: thread (ry,
  // cx) of the group keeps rows ry + RW*u and columns cx + CW*v; its 16
  // values are loaded before the products, so the loads overlap them
  constexpr int CW = 16, RW = G / CW;
  const int cx = lt % CW, ry = lt / CW;
  for (int r0 = 0; r0 < rb; r0 += 4 * RW)
    for (int c0 = 0; c0 < rb; c0 += 4 * CW) {
      int ri[4], ci[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ri[u] = r0 + ry + RW * u;
        ci[u] = c0 + cx + CW * u;
      }
      T cv[4][4], acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] = T(0);
          cv[u][v] = (ri[u] < rb && ci[v] < rb)
                         ? Ff[(wb + ri[u]) * mb + wb + ci[v]]
                         : T(0);
        }
      for (int k = 0; k < wb; ++k) {
        T a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = P[(wb + min(ri[u], rb - 1)) * LP + k];
          b[u] = S[k * LS + min(ci[u], rb - 1)];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (ri[u] < rb && ci[v] < rb)
            Ff[(wb + ri[u]) * mb + wb + ci[v]] = cv[u][v] - acc[u][v];
    }
}

// ------------------------------------------------------------- large

// Shared-memory regions of panel_step and strip_solve: three tiles of
// PB x LDB elements (an A operand uses stride LDL, a B operand LDB, a
// diagonal block LDD; each fits).
constexpr int REG = PB * LDB;
constexpr int PANEL_SMEM = 3 * REG;

// The large regime's workspace, per front: inv(L11) and inv(U11) of
// every panel block's diagonal block (PB x PB each, row stride PB), then
// the panel's L (mb x wb) and U (wb x wb) values (row stride wb), which
// panel_copy moves into F at the end of the panel phase.
struct Work {
  int64_t per_front, inv, pl, pu;
  __host__ __device__ Work(int mb, int wb) {
    const int64_t nblk = (wb + PB - 1) / PB;
    inv = 0;
    pl = nblk * 2 * PB * PB;
    pu = pl + static_cast<int64_t>(mb) * wb;
    per_front = pu + static_cast<int64_t>(wb) * wb;
  }
};

template <typename T>
__device__ __forceinline__ T* inv_block(T* work, const Work& w, int64_t f,
                                        int b, int which) {
  return work + f * w.per_front + w.inv + (b * 2 + which) * PB * PB;
}

// Launch j of the panel phase (0 <= j <= nblk; block b spans columns
// [b*PB, min((b+1)*PB, wb)), and row block r rows [r*PB, ...)).
// blockIdx.x: the row tile (rows from min(j*PB, wb) on, 64 each),
// blockIdx.y: a column block c >= j of the panel (one pseudo-column at
// j == nblk), blockIdx.z: the front.  For j >= 1 the CTA computes, on
// the tensor cores in float64,
//   Lt = A[tile rows, block j-1] * inv(U11_{j-1})   (its rows of L),
//   Uc = inv(L11_{j-1}) * A[block j-1 rows, block c] (U's block c),
// and, for c < nblk, A[tile rows, block c] -= Lt * Uc, its own tile.
// Lt and Uc go to the workspace (from the CTAs of column 0 and of row
// tile 0), never over what another CTA of the launch reads.  The CTA
// holding block j's diagonal tile (row tile 0, c == j) then factors it
// (GESP, counters) into F and keeps its inverses: with factor_invert,
// whose sequential steps run in single warps, unless the launch is busy
// (more CTAs than SMs), where the head shares its SM with the bulk and
// the all-warps factor_diag / invert_diag finish sooner.
template <typename T>
__global__ void __launch_bounds__(NT)
panel_step(T* __restrict__ F, T* __restrict__ work, int mb, int wb, int j,
           const double* __restrict__ thp, int* __restrict__ tiny,
           int* __restrict__ nzero, bool busy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R0 = reinterpret_cast<T*>(smem_raw);
  T* R1 = R0 + REG;
  T* R2 = R1 + REG;
  const Work wk(mb, wb);
  const int64_t f = blockIdx.z;
  T* Ff = F + f * mb * mb;
  const int nblk = (wb + PB - 1) / PB;
  const int rs = min(j * PB, wb);
  const int r0 = rs + blockIdx.x * RT;
  const int nrows = min(RT, mb - r0);
  const int c = j + blockIdx.y;            // column block (nblk: none)
  const int cb = c * PB, nc = min(PB, wb - cb);

  if (j >= 1) {
    const int k0 = (j - 1) * PB, kb = min(PB, wb - k0);
    const int kd = (kb + 7) & ~7;
    Tile<T, RT, CT> core;
    // Lt = A * inv(U11) into R0 (A operand layout)
    load_block(R1, LDL, Ff + static_cast<int64_t>(r0) * mb + k0, mb,
               nrows, kb, RT, kd);
    load_block(R2, LDB, inv_block(work, wk, f, j - 1, 1), PB, kb, kb, kd,
               CT);
    __syncthreads();
    core.zero();
    core.step(R1, LDL, R2, LDB, kd);
    T* pl = work + f * wk.per_front + wk.pl +
            static_cast<int64_t>(r0) * wb + k0;
    const bool wl = blockIdx.y == 0;
    core.store(RT, kd, [&](int r, int cc, T v) {
      R0[r * LDL + cc] = cc < kb ? v : T(0);
      if (wl && r < nrows && cc < kb) pl[r * wb + cc] = v;
    });
    __syncthreads();
    if (c < nblk) {
      // Uc = inv(L11) * A[block j-1 rows, block c] into R1 (B layout)
      load_block(R1, LDL, inv_block(work, wk, f, j - 1, 0), PB, kb, kb, RT,
                 kd);
      load_block(R2, LDB, Ff + k0 * mb + cb, mb, kb, nc, kd, CT);
      __syncthreads();
      core.zero();
      core.step(R1, LDL, R2, LDB, kd);
      __syncthreads();
      T* pu = work + f * wk.per_front + wk.pu +
              static_cast<int64_t>(k0) * wb + cb;
      const bool wu = blockIdx.x == 0;
      core.store(kd, CT, [&](int r, int cc, T v) {
        R1[r * LDB + cc] = (r < kb && cc < nc) ? v : T(0);
        if (wu && r < kb && cc < nc) pu[r * wb + cc] = v;
      });
      __syncthreads();
      // the CTA's own tile -= Lt * Uc
      core.zero();
      core.step(R0, LDL, R1, LDB, kd);
      core.rmw(Ff + static_cast<int64_t>(r0) * mb + cb, mb, nrows, nc);
    }
    __syncthreads();
  }

  if (c == j && j < nblk && blockIdx.x == 0) {
    const int k0 = j * PB, kb = nc;
    load_block(R1, LDD, Ff + k0 * mb + k0, mb, kb, kb, PB, PB);
    __syncthreads();
    int ltiny = 0, lzero = 0;
    const real_t<T> thresh = static_cast<real_t<T>>(*thp);
    if (busy) {
      factor_diag(R1, kb, thresh, ltiny, lzero);
      invert_diag(R1, kb, R0, R2);
    } else {
      factor_invert(R1, kb, thresh, R0, R2, ltiny, lzero);
    }
    if (threadIdx.x == 0) {
      tiny[f] += ltiny;
      nzero[f] += lzero;
    }
    T* wl = inv_block(work, wk, f, j, 0);
    T* wu = inv_block(work, wk, f, j, 1);
    for (int r = threadIdx.x / 32; r < PB; r += NT / 32)
      for (int cc = threadIdx.x % 32; cc < PB; cc += 32) {
        if (r < kb && cc < kb) Ff[(k0 + r) * mb + k0 + cc] = R1[r * LDD + cc];
        wl[r * PB + cc] = R0[r * LDL + cc];
        wu[r * PB + cc] = R2[r * LDL + cc];
      }
  }
}

// The end of the panel phase: the L and U values kept in the workspace
// go into F (the diagonal blocks are there already).  blockIdx.x: 64
// rows, blockIdx.y: the front.
template <typename T>
__global__ void __launch_bounds__(NT)
panel_copy(T* __restrict__ F, const T* __restrict__ work, int mb, int wb) {
  const Work wk(mb, wb);
  const int64_t f = blockIdx.y;
  T* Ff = F + f * mb * mb;
  const T* pl = work + f * wk.per_front + wk.pl;
  const T* pu = work + f * wk.per_front + wk.pu;
  const int r1 = min(mb, static_cast<int>(blockIdx.x + 1) * RT);
  for (int r = blockIdx.x * RT + threadIdx.x / 32; r < r1; r += NT / 32) {
    const int b0 = (r < wb) ? (r / PB) * PB : wb;  // r's diagonal block
    const int b1 = (r < wb) ? min(b0 + PB, wb) : wb;
    const int64_t ro = static_cast<int64_t>(r) * mb;
    const int64_t rw = static_cast<int64_t>(r) * wb;
    for (int cc = threadIdx.x % 32; cc < wb; cc += 32) {
      if (cc < b0)
        Ff[ro + cc] = pl[rw + cc];
      else if (cc >= b1)
        Ff[ro + cc] = pu[rw + cc];
    }
  }
}

// U12 = inv(L11) * F12, left-looking over the panel blocks:
// X_b = inv(L_bb) * (F12_b - sum_{p<b} L_bp X_p), every product on the
// tensor cores in float64.  blockIdx.x: 64 columns of the strip,
// blockIdx.y: the front.
template <typename T>
__global__ void __launch_bounds__(NT)
strip_solve(T* __restrict__ F, T* __restrict__ work, int mb, int wb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + REG;
  const Work wk(mb, wb);
  const int64_t f = blockIdx.y;
  T* Ff = F + f * mb * mb;
  const int c0 = wb + blockIdx.x * CT;
  const int nc = min(CT, mb - c0);
  const int nblk = (wb + PB - 1) / PB;
  Tile<T, RT, CT> core;
  for (int b = 0; b < nblk; ++b) {
    const int k0 = b * PB, kb = min(PB, wb - k0);
    const int kd = (kb + 7) & ~7;
    core.zero();
    for (int p = 0; p < b; ++p) {  // blocks p < b are full
      load_block(As, LDL, Ff + k0 * mb + p * PB, mb, kb, PB, RT, PB);
      load_block(Bs, LDB, Ff + p * PB * mb + c0, mb, PB, nc, PB, CT);
      __syncthreads();
      core.step(As, LDL, Bs, LDB, PB);
      __syncthreads();
    }
    // W = F12_b - sum, in the B region; then X_b = inv(L_bb) * W
    load_block(Bs, LDB, Ff + k0 * mb + c0, mb, kb, nc, kd, CT);
    load_block(As, LDL, inv_block(work, wk, f, b, 0), PB, kb, kb, RT, kd);
    __syncthreads();
    core.store(kb, nc, [&](int r, int cc, T v) { Bs[r * LDB + cc] -= v; });
    __syncthreads();
    core.zero();
    core.step(As, LDL, Bs, LDB, kd);
    T* Xg = Ff + k0 * mb + c0;
    core.store(kb, nc, [&](int r, int cc, T v) { Xg[r * mb + cc] = v; });
    __syncthreads();
  }
}

// Stage a ROWS x COLS tile of a row-major global matrix (stride ld) into
// shared memory (stride LDS) with cp.async, zero-filling rows >= nrows
// and columns >= ncols; 16-byte copies when `vec` (row starts and the
// tile's first column 16-byte aligned).
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src,
                                      int64_t ld, int nrows, int ncols,
                                      bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  static_assert(COLS % E == 0, "16-byte chunks");
  if (vec) {
    constexpr int CPR = COLS / E;
    for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * E;
      int left = (r < nrows) ? (ncols - col) : 0;
      left = left < 0 ? 0 : (left > E ? E : left);
      const T* g = (left > 0) ? src + r * ld + col : src;
      cp_async<16>(dst + r * LDS + col, g,
                   left * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * COLS; c += NT) {
      const int r = c / COLS, col = c % COLS;
      const bool ok = r < nrows && col < ncols;
      cp_async<sizeof(T)>(dst + r * LDS + col,
                          ok ? src + r * ld + col : src,
                          ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// F22 -= L21 * U12 at depth wb.  Grid: x = column tile, y = row tile,
// z = front.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
schur_update(T* __restrict__ F, int mb, int wb) {
  constexpr int UBM = Upd<T>::BM, UBN = Upd<T>::BN, UBK = Upd<T>::BK,
                USTAGES = Upd<T>::ST;
  constexpr int LA = UBK + 4, LB = UBN + 8;
  constexpr int SA = UBM * LA, SB = UBK * LB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + USTAGES * SA;
  const int64_t f = blockIdx.z;
  T* Ff = F + f * mb * mb;
  const int rb = mb - wb;
  const int m0 = blockIdx.y * UBM, n0 = blockIdx.x * UBN;
  const int nrows = min(UBM, rb - m0), ncols = min(UBN, rb - n0);
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const bool vec = (mb % E == 0) && (wb % E == 0);
  const T* Ag = Ff + static_cast<int64_t>(wb + m0) * mb;  // L21 rows
  const T* Bg = Ff + wb + n0;                             // U12 columns
  const int nk = (wb + UBK - 1) / UBK;
  auto load = [&](int kt) {
    const int slot = kt % USTAGES, k0 = kt * UBK;
    const int kk = min(UBK, wb - k0);
    stage<T, UBM, UBK, LA>(As + slot * SA, Ag + k0, mb, nrows, kk, vec);
    stage<T, UBK, UBN, LB>(Bs + slot * SB, Bg + static_cast<int64_t>(k0) * mb,
                           mb, kk, ncols, vec);
  };
#pragma unroll
  for (int s = 0; s < USTAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  Tile<T, UBM, UBN> core;
  core.zero();
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<USTAGES - 2>();
    __syncthreads();
    const int nxt = kt + USTAGES - 1;
    if (nxt < nk) load(nxt);
    cp_commit();
    const int slot = kt % USTAGES;
    core.step(As + slot * SA, LA, Bs + slot * SB, LB, UBK);
  }
  core.rmw(Ff + static_cast<int64_t>(wb + m0) * mb + wb + n0, mb, nrows,
           ncols);
}

// -------------------------------------------------------------- host

template <typename T>
int64_t small_smem(int64_t mb, int64_t wb) {
  if (mb <= WARP_MB) return 0;   // warp mode: registers only
  const int64_t G = NT;
  const int64_t pad = small_pad<T>(static_cast<int>(mb),
                                   static_cast<int>(wb));
  return (NT / G) * (mb * (wb + pad) + wb * (mb - wb + pad)) *
         static_cast<int64_t>(sizeof(T));
}

template <typename K>
cudaError_t set_smem(K kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// work: the large regime's workspace, N * Work(mb, wb).per_front
// elements (unused by the small regime)
template <typename T>
int run(void* Fv, void* workv, int64_t N, int64_t mb, int64_t wb,
        int64_t regime, const void* thresh, void* tiny, void* nzero,
        void* stream) {
  if (N <= 0) return 0;
  if (wb < 1 || wb > mb || mb > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  T* F = static_cast<T*>(Fv);
  T* work = static_cast<T*>(workv);
  int* tn = static_cast<int*>(tiny);
  int* zn = static_cast<int*>(nzero);
  const double* th = static_cast<const double*>(thresh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (regime == 0) {
    const int64_t smem = small_smem<T>(mb, wb);
    if (mb <= WARP_MB) {
      lu_small<T, 32><<<(unsigned)ceil_div(N, NT / 32), NT, 0, s>>>(
          F, N, (int)mb, (int)wb, th, tn, zn);
    } else {
      if ((e = set_smem(lu_small<T, NT>, smem)) != cudaSuccess)
        return static_cast<int>(e);
      lu_small<T, NT><<<(unsigned)N, NT, smem, s>>>(F, N, (int)mb,
                                                   (int)wb, th, tn, zn);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != 1 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t it = sizeof(T);
  const int64_t sm_panel = PANEL_SMEM * it;
  using U = Upd<T>;
  const int64_t sm_upd = U::ST * (U::BM * (U::BK + 4) + U::BK * (U::BN + 8)) * it;
  if ((e = set_smem(panel_step<T>, sm_panel)) != cudaSuccess ||
      (e = set_smem(strip_solve<T>, sm_panel)) != cudaSuccess ||
      (e = set_smem(schur_update<T>, sm_upd)) != cudaSuccess)
    return static_cast<int>(e);
  int dev = 0, nsm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int64_t rb = mb - wb;
  const int64_t nblk = ceil_div(wb, PB);
  for (int64_t f0 = 0; f0 < N; f0 += 65535) {
    const int64_t nf = (N - f0 < 65535) ? (N - f0) : 65535;
    T* Fc = F + f0 * mb * mb;
    T* Wc = work + f0 * Work((int)mb, (int)wb).per_front;
    for (int64_t j = 0; j <= nblk; ++j) {
      const int64_t rs = (j * PB < wb) ? j * PB : wb;
      const int64_t tiles = (j == 0) ? 1 : ceil_div(mb - rs, RT);
      const int64_t cols = (j == 0) ? 1 : (nblk - j > 1 ? nblk - j : 1);
      if (tiles == 0) continue;
      const bool busy = tiles * cols * nf > nsm;
      panel_step<T><<<dim3((unsigned)tiles, (unsigned)cols, (unsigned)nf),
                      NT, sm_panel, s>>>(Fc, Wc, (int)mb, (int)wb, (int)j,
                                         th, tn + f0, zn + f0, busy);
      if ((e = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(e);
    }
    panel_copy<T><<<dim3((unsigned)ceil_div(mb, RT), (unsigned)nf), NT, 0,
                    s>>>(Fc, Wc, (int)mb, (int)wb);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (rb == 0) continue;
    strip_solve<T><<<dim3((unsigned)ceil_div(rb, CT), (unsigned)nf), NT,
                     sm_panel, s>>>(Fc, Wc, (int)mb, (int)wb);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    schur_update<T><<<dim3((unsigned)ceil_div(rb, U::BN),
                           (unsigned)ceil_div(rb, U::BM), (unsigned)nf),
                      NT, sm_upd, s>>>(Fc, (int)mb, (int)wb);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 lane: the fronts widened into a float32 copy at the head
// of `work`, the float32 lane run on that copy (the rest of `work` its
// workspace), and every element rounded once back into F.
constexpr int64_t CONVERT_CTAS = 132 * 8;   // grid-stride conversions

__global__ void __launch_bounds__(NT)
widen_fronts(const bf16* __restrict__ src, float* __restrict__ dst,
             int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * NT)
    dst[i] = __bfloat162float(src[i]);
}

__global__ void __launch_bounds__(NT)
narrow_fronts(const float* __restrict__ src, bf16* __restrict__ dst,
              int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * NT)
    dst[i] = __float2bfloat16_rn(src[i]);
}

int run_bf16(void* Fv, void* workv, int64_t N, int64_t mb, int64_t wb,
             int64_t regime, const void* thresh, void* tiny, void* nzero,
             void* stream) {
  if (N <= 0) return 0;
  if (workv == nullptr || mb > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = N * mb * mb;
  bf16* F = static_cast<bf16*>(Fv);
  float* Fw = static_cast<float*>(workv);
  const int64_t b = ceil_div(n, NT);
  const unsigned blocks =
      static_cast<unsigned>(b < CONVERT_CTAS ? b : CONVERT_CTAS);
  widen_fronts<<<blocks, NT, 0, s>>>(F, Fw, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = run<float>(Fw, regime == 1 ? Fw + n : nullptr, N, mb, wb,
                            regime, thresh, tiny, nzero, stream);
  if (rc != 0) return rc;
  narrow_fronts<<<blocks, NT, 0, s>>>(Fw, F, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: N * mb * mb float32 (the working fronts), then the float32
// lane's workspace
extern "C" int slu_panel_lu_bf16(void* F, void* work, int64_t N,
                                 int64_t mb, int64_t wb, int64_t regime,
                                 const void* thresh, void* tiny,
                                 void* nzero, void* stream) {
  return run_bf16(F, work, N, mb, wb, regime, thresh, tiny, nzero, stream);
}

extern "C" int slu_panel_lu_f32(void* F, void* work, int64_t N,
                                int64_t mb, int64_t wb, int64_t regime,
                                const void* thresh, void* tiny,
                                void* nzero,
                                void* stream) {
  return run<float>(F, work, N, mb, wb, regime, thresh, tiny, nzero,
                    stream);
}

extern "C" int slu_panel_lu_f64(void* F, void* work, int64_t N,
                                int64_t mb, int64_t wb, int64_t regime,
                                const void* thresh, void* tiny,
                                void* nzero,
                                void* stream) {
  return run<double>(F, work, N, mb, wb, regime, thresh, tiny, nzero,
                     stream);
}

extern "C" int slu_panel_lu_c64(void* F, void* work, int64_t N,
                                int64_t mb, int64_t wb, int64_t regime,
                                const void* thresh, void* tiny,
                                void* nzero, void* stream) {
  return run<c64>(F, work, N, mb, wb, regime, thresh, tiny, nzero, stream);
}

extern "C" int slu_panel_lu_c128(void* F, void* work, int64_t N,
                                 int64_t mb, int64_t wb, int64_t regime,
                                 const void* thresh, void* tiny,
                                 void* nzero, void* stream) {
  return run<c128>(F, work, N, mb, wb, regime, thresh, tiny, nzero, stream);
}
