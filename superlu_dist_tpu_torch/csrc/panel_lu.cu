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
// zeros (thresh == 0) are accumulated into tiny[f] / nzero[f].
//
// What bounds it on an H100: the trailing update.  Its operations
// (about 2*wb*mb^2 per front) dominate, and each block step reads and
// writes the whole trailing matrix once, so at depth nb = 32 the update
// runs at ~4 flop/byte in float64: memory-bound for large fronts.
//
// Design: a blocked right-looking LU with nb = min(32, wb), three
// launches per block step on the caller's stream:
//   1. diag_factor: one CTA per front factors the nb x nb diagonal block
//      in shared memory with rank-1 steps, tiny-pivot replacement and
//      the per-front counters;
//   2. panel_trsm: L21 = A21 * U11^-1 (one thread per row) and
//      U12 = L11^-1 * A12 (one thread per column) by substitution
//      against the diagonal block held in shared memory;
//   3. schur: F22 -= L21 * U12 as a shared-memory-tiled SIMT product
//      over (column tile, row tile, front) CTAs, 64 x 64 outputs per
//      CTA, so the few very large fronts of the top levels still spread
//      over every SM.
// A later version fuses the steps and moves the update to the tensor
// cores (wgmma, TMA); this one is the simple, correct form.
#include "common.cuh"

namespace {

constexpr int NBMAX = 32;
constexpr int TS_TRSM = 128;   // threads (rows or columns) per trsm CTA
constexpr int BM = 64;         // schur tile rows
constexpr int BN = 64;         // schur tile columns

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

template <typename T>
__global__ void diag_factor_kernel(T* __restrict__ F, int64_t mb,
                                   int64_t k0, int nb, T thresh,
                                   int* __restrict__ tiny,
                                   int* __restrict__ nzero) {
  __shared__ T D[NBMAX][NBMAX + 1];
  const int64_t f = blockIdx.x;
  T* Ff = F + f * mb * mb;
  for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
    const int i = idx / nb, j = idx % nb;
    D[i][j] = Ff[(k0 + i) * mb + k0 + j];
  }
  __syncthreads();
  int ltiny = 0, lzero = 0;
  for (int t = 0; t < nb; ++t) {
    const T piv = D[t][t];
    const T apiv = tabs(piv);
    const bool is_tiny = apiv < thresh;
    const T newpiv = is_tiny ? (piv >= T(0) ? thresh : -thresh) : piv;
    ltiny += is_tiny ? 1 : 0;
    lzero += (apiv == T(0) && !is_tiny) ? 1 : 0;
    __syncthreads();   // every thread has read D[t][t]
    for (int i = t + 1 + threadIdx.x; i < nb; i += blockDim.x)
      D[i][t] = D[i][t] / newpiv;
    if (threadIdx.x == 0) D[t][t] = newpiv;
    __syncthreads();
    const int m = nb - t - 1;
    for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
      const int i = t + 1 + idx / m, j = t + 1 + idx % m;
      D[i][j] -= D[i][t] * D[t][j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
    const int i = idx / nb, j = idx % nb;
    Ff[(k0 + i) * mb + k0 + j] = D[i][j];
  }
  if (threadIdx.x == 0) {
    tiny[f] += ltiny;
    nzero[f] += lzero;
  }
}

// blockIdx.y < ntiles: L21 rows; otherwise U12 columns.
template <typename T>
__global__ void panel_trsm_kernel(T* __restrict__ F, int64_t mb,
                                  int64_t k0, int nb, int64_t ntiles) {
  __shared__ T D[NBMAX][NBMAX + 1];
  const int64_t f = blockIdx.x;
  T* Ff = F + f * mb * mb;
  for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
    const int i = idx / nb, j = idx % nb;
    D[i][j] = Ff[(k0 + i) * mb + k0 + j];
  }
  __syncthreads();
  const int64_t k1 = k0 + nb;
  const int64_t tile = blockIdx.y;
  T x[NBMAX];
  if (tile < ntiles) {
    // x * U11 = a for one row a of A21 (U11 upper, non-unit)
    const int64_t r = k1 + tile * TS_TRSM + threadIdx.x;
    if (r >= mb) return;
    T* row = Ff + r * mb + k0;
#pragma unroll
    for (int j = 0; j < NBMAX; ++j)
      if (j < nb) x[j] = row[j];
#pragma unroll
    for (int j = 0; j < NBMAX; ++j) {
      if (j < nb) {
        T s = x[j];
#pragma unroll
        for (int i = 0; i < j; ++i) s -= x[i] * D[i][j];
        x[j] = s / D[j][j];
      }
    }
#pragma unroll
    for (int j = 0; j < NBMAX; ++j)
      if (j < nb) row[j] = x[j];
  } else {
    // L11 * x = a for one column a of A12 (L11 unit lower)
    const int64_t c = k1 + (tile - ntiles) * TS_TRSM + threadIdx.x;
    if (c >= mb) return;
    T* col = Ff + k0 * mb + c;
#pragma unroll
    for (int i = 0; i < NBMAX; ++i)
      if (i < nb) x[i] = col[i * mb];
#pragma unroll
    for (int i = 0; i < NBMAX; ++i) {
      if (i < nb) {
        T s = x[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= D[i][k] * x[k];
        x[i] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NBMAX; ++i)
      if (i < nb) col[i * mb] = x[i];
  }
}

// F22 -= L21 * U12 over rows/cols >= k0+nb, depth nb; 256 threads,
// each owning a 4 x 4 set of outputs strided by 16.
template <typename T>
__global__ void __launch_bounds__(256)
schur_kernel(T* __restrict__ F, int64_t mb, int64_t k0, int nb) {
  __shared__ T As[NBMAX][BM];   // As[k][m] = L21[m][k]
  __shared__ T Bs[NBMAX][BN];   // Bs[k][n] = U12[k][n]
  const int64_t f = blockIdx.z;
  T* Ff = F + f * mb * mb;
  const int64_t k1 = k0 + nb;
  const int64_t m0 = k1 + (int64_t)blockIdx.y * BM;
  const int64_t n0 = k1 + (int64_t)blockIdx.x * BN;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BM * nb; idx += 256) {
    const int m = idx / nb, k = idx % nb;
    const int64_t r = m0 + m;
    As[k][m] = (r < mb) ? Ff[r * mb + k0 + k] : T(0);
  }
  for (int idx = tid; idx < nb * BN; idx += 256) {
    const int k = idx / BN, n = idx % BN;
    const int64_t c = n0 + n;
    Bs[k][n] = (c < mb) ? Ff[(k0 + k) * mb + c] : T(0);
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  for (int k = 0; k < nb; ++k) {
    T a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= mb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c < mb) Ff[r * mb + c] -= acc[i][j];
    }
  }
}

template <typename T>
int run(void* Fv, int64_t N, int64_t mb, int64_t wb, int64_t nb,
        double thresh, void* tiny, void* nzero, void* stream) {
  if (N <= 0) return 0;
  if (nb < 1 || nb > NBMAX || wb % nb != 0 || wb > mb)
    return static_cast<int>(cudaErrorInvalidValue);
  T* F = static_cast<T*>(Fv);
  int* tn = static_cast<int*>(tiny);
  int* zn = static_cast<int*>(nzero);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t k0 = 0; k0 < wb; k0 += nb) {
    diag_factor_kernel<T><<<(unsigned)N, 256, 0, s>>>(
        F, mb, k0, (int)nb, static_cast<T>(thresh), tn, zn);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t rest = mb - k0 - nb;
    if (rest <= 0) continue;
    const int64_t ntiles = ceil_div(rest, TS_TRSM);
    panel_trsm_kernel<T><<<dim3((unsigned)N, (unsigned)(2 * ntiles)),
                           TS_TRSM, 0, s>>>(F, mb, k0, (int)nb, ntiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned tc = (unsigned)ceil_div(rest, BN);
    const unsigned tr = (unsigned)ceil_div(rest, BM);
    for (int64_t f0 = 0; f0 < N; f0 += 65535) {
      const int64_t nf = (N - f0 < 65535) ? (N - f0) : 65535;
      schur_kernel<T><<<dim3(tc, tr, (unsigned)nf), 256, 0, s>>>(
          F + f0 * mb * mb, mb, k0, (int)nb);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int slu_panel_lu_f32(void* F, int64_t N, int64_t mb,
                                int64_t wb, int64_t nb, double thresh,
                                void* tiny, void* nzero, void* stream) {
  return run<float>(F, N, mb, wb, nb, thresh, tiny, nzero, stream);
}

extern "C" int slu_panel_lu_f64(void* F, int64_t N, int64_t mb,
                                int64_t wb, int64_t nb, double thresh,
                                void* tiny, void* nzero, void* stream) {
  return run<double>(F, N, mb, wb, nb, thresh, tiny, nzero, stream);
}
