// Kernel K3: the fused forward lsum step of one trisolve group.
//
// Replaces the Pallas kernel of the reference package,
// superlu_dist_tpu/ops/pallas_lsum.py (`lsum_panel`, body
// `_lsum_kernel`, member `fwd_member`), reached from ops/trisolve.sweep
// for non-transposed members.  For each front n of the group:
//     y   = Li[n] * xb[n]            (wb x wb) * (wb x R)
//     upd = L21[n][:rtrim] * y       (rtrim x wb) * (wb x R)
// y is written straight into the solve buffer Y at row y_off + n*wb and
// upd into the lsum buffer UPD at row u_off + n*rtrim (both row-major, R
// columns), replacing the reference's two dynamic_update_slice writes.
//
// The panels (TP) and the right-hand sides (TX) are separate template
// types: in refinement, float32 factors meet a float64 residual, and the
// products then run in float64 on the float32 panels without an
// up-cast copy of them (each panel value is widened as it is read).
//
// What bounds it on an H100: at one right-hand side, bytes (every panel
// element is used for one multiply-add); at 64 right-hand sides the
// panels are still most of the bytes, but in float64 the arithmetic (64
// multiply-adds per panel element) needs the FP64 tensor cores to stay
// below the byte time, and in float32 the FMA pipes.
//
// Design: one wrapper call, no fallback; `run` picks by shape.
//   * Narrow fronts that alone fill the card (wb <= the row tile, at
//     least 2 CTAs per SM): one launch, `lsum_fused`, one CTA per
//     (front, column tile); y is computed over x in shared memory and
//     the rows of L21 stream against it.
//   * Otherwise two launches, y = Li*xb into Y, then upd = L21*y with y
//     read back from Y in L2 (wb*R values per front against the
//     rtrim*wb panel values streamed), so Li is read once per front and
//     no CTA recomputes y:
//       - one right-hand side: `row_dots`, panel rows streamed straight
//         into registers with 16-byte loads, 4 rows per warp sharing
//         each value of x;
//       - more: `tile_product`, grid (front x column tile, row tile),
//         up to 64 right-hand sides per CTA (every panel element read
//         from device memory once at nrhs <= 64), panel and
//         right-hand-side tiles staged through a cp.async ring (16-byte
//         copies where rows are 16-byte aligned, zero-filled past the
//         edges).  Few tiles (the wide fronts near the root) split the
//         depth over a thread-block cluster of up to 8 CTAs whose
//         partial tiles are summed through distributed shared memory in
//         rank order (deterministic).
//   The tile products: float64 right-hand sides and more than 4 of them
//   on the FP64 tensor cores (mma.sync m16n8k8, the sm_90 shape: the
//   older m8n8k4 leaves the tensor cores well short of their peak on
//   Hopper); otherwise FMA with register blocking (TM x TN sums per
//   thread, every panel value read from shared memory feeds TN
//   right-hand sides, KL lanes over the depth summed once at the end
//   and reduce-scattered so that neighbouring lanes store neighbouring
//   columns with 16-byte stores).
// TF32 is never used: float32 stays float32 (the refinement contract).
//
// bfloat16 panels (bf16_f32, bf16_f64: a bfloat16 factorization solves
// with float32 or float64 right-hand sides): a simple kernel of their
// own, `bf16_rows` below, up to 4 right-hand sides; above, the float32
// panel lanes on a widened copy.
// Complex lanes (the complex type of common.cuh): complex64 panels with
// complex64 right-hand sides, complex128 with complex128, and complex64
// panels with complex128 right-hand sides (the mixed mode, each panel
// value widened as it is read, as float32 panels are for float64).  They
// run the same kernels with complex FMAs on the CUDA cores (never the
// tensor cores), at most 16 right-hand sides per CTA so that a thread's
// complex sums stay in registers.  Real panels with complex right-hand
// sides need no lane: the wrapper passes the right-hand sides as real
// columns (re, im interleaved, 2R of them) to the real lanes.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;      // threads per CTA (4 warps)
constexpr int STAGES = 3;    // cp.async ring depth of the fused kernel

// Stage a ROWS x COLS tile of a row-major global matrix (row stride ld
// elements) into shared memory (row stride LDS), zero-filling rows >=
// nrows and columns >= ncols.  vec: every row start is 16-byte aligned,
// so the copies are 16 bytes; otherwise one element each.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int64_t ld, int nrows,
                                           int ncols, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (vec && COLS % E == 0) {
    constexpr int CPR = COLS / E;  // chunks per row
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

// ------------------------------------------------------- tile configs

// BN right-hand sides per CTA -> rows per CTA, depth per stage, and the
// FMA layout (TM rows x TN columns per thread, KL lanes over the depth)
template <int BN>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int BM = 32, BK = 64, TM = 1, TN = 1, KL = 4;
};
template <>
struct Tile<4> {
  static constexpr int BM = 64, BK = 32, TM = 2, TN = 4, KL = 4;
};
template <>
struct Tile<16> {
  static constexpr int BM = 64, BK = 32, TM = 4, TN = 4, KL = 2;
};
template <>
struct Tile<64> {
  static constexpr int BM = 64, BK = 32, TM = 8, TN = 8, KL = 2;
};

template <typename TX, int BN>
struct UseMma {
  static constexpr bool value = std::is_same<TX, double>::value && BN >= 16;
};

// Ring depth of the tile products.  The tensor-core tiles are large,
// and a two-stage ring fits three CTAs (12 warps) on an SM, which hides
// more latency than deeper stages do.
template <typename TX, int BN>
struct Ring {
  static constexpr int N = UseMma<TX, BN>::value ? 2 : 3;
};

// shared-memory row strides (elements).  Panel rows: BK + 4, so the 8
// rows x 4 depths an mma fragment or a lane group reads fall in distinct
// banks.  Right-hand-side rows: BN + 8 for the tensor-core path (its 4
// depths x 8 columns hit distinct banks), BN + 4 for FMA (16-byte rows).
template <typename TX, int BN>
struct Layout {
  static constexpr int BM = Tile<BN>::BM, BK = Tile<BN>::BK;
  static constexpr int LDA = BK + 4;
  static constexpr int LDB =
      UseMma<TX, BN>::value ? BN + 8 : (BN >= 4 ? BN + 4 : BN);
};

// ------------------------------------------------------ the products

// Tensor-core path: warps WM x WN over the BM x BN tile, each an
// (FM*8) x (FN*8) block of 8x8 accumulator fragments, two of them
// (rows i, i+1) per m16n8k8 product.
template <typename TP, int BN>
struct MmaCore {
  static constexpr int BM = Tile<BN>::BM, BK = Tile<BN>::BK;
  static constexpr int WN = (BN >= 64) ? 2 : 1, WM = 4 / WN;
  static constexpr int FM = BM / WM / 8, FN = BN / WN / 8;
  static_assert(FM % 2 == 0 && BK % 8 == 0, "m16n8k8 tiling");
  static constexpr int LDA = Layout<double, BN>::LDA;
  static constexpr int LDB = Layout<double, BN>::LDB;
  static constexpr int NV = 2;  // values per store() call, at most
  double acc[FM][FN][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  }

  __device__ __forceinline__ void step(const TP* __restrict__ As,
                                       const double* __restrict__ Bs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp / WN) * (FM * 8), c0 = (warp % WN) * (FN * 8);
#pragma unroll
    for (int k = 0; k < BK; k += 8) {
      double a[FM][2], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][h] = static_cast<double>(
              As[(r0 + i * 8 + g) * LDA + k + q + 4 * h]);
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[j][h] = Bs[(k + q + 4 * h) * LDB + c0 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < FM; i += 2)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          dmma(acc[i][j][0], acc[i][j][1], acc[i + 1][j][0],
               acc[i + 1][j][1], a[i][0], a[i + 1][0], a[i][1], a[i + 1][1],
               b[j][0], b[j][1]);
    }
  }

  // out(row, col, values, count): `count` (1 or 2) consecutive values of
  // row `row` from column `col`, for every (row < nrows, col < ncols)
  template <typename Out>
  __device__ __forceinline__ void store(int nrows, int ncols, Out out) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp / WN) * (FM * 8), c0 = (warp % WN) * (FN * 8);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int r = r0 + i * 8 + g, c = c0 + j * 8 + 2 * q;
        if (r < nrows && c < ncols)
          out(r, c, acc[i][j], (ncols - c < 2) ? ncols - c : 2);
      }
  }
};

// FMA path with register blocking: thread (rg, cg, kl) keeps the sums of
// rows rg + RS*i (i < TM) and columns cg*TN + j (j < TN) over the depths
// kl, kl + KL, ... of every stage.
template <typename TP, typename TX, int BN>
struct FmaCore {
  using T = Tile<BN>;
  static constexpr int BM = T::BM, BK = T::BK, TM = T::TM, TN = T::TN,
                       KL = T::KL;
  static constexpr int RS = BM / TM, CS = BN / TN;
  static_assert(RS * CS * KL == NT, "tile does not match the CTA");
  static constexpr int LDA = Layout<TX, BN>::LDA;
  static constexpr int LDB = Layout<TX, BN>::LDB;
  static constexpr int NV = (TN % KL == 0) ? TN / KL : TN;
  TX acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = TX(0);
  }

  __device__ __forceinline__ void step(const TP* __restrict__ As,
                                       const TX* __restrict__ Bs) {
    const int kl = threadIdx.x % KL, cg = (threadIdx.x / KL) % CS,
              rg = threadIdx.x / (KL * CS);
#pragma unroll
    for (int s = 0; s < BK / KL; ++s) {
      const int k = kl + KL * s;
      TX a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = static_cast<TX>(As[(rg + RS * i) * LDA + k]);
      const TX* br = Bs + k * LDB + cg * TN;
      if constexpr (std::is_same<TX, float>::value && TN % 4 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(br + j);
          b[j] = v.x, b[j + 1] = v.y, b[j + 2] = v.z, b[j + 3] = v.w;
        }
      } else if constexpr (std::is_same<TX, double>::value && TN % 2 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 2) {
          const double2 v = *reinterpret_cast<const double2*>(br + j);
          b[j] = v.x, b[j + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = br[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
  }

  // The KL lanes of a (row, column) group are adjacent.  With TN a
  // multiple of KL their sums are reduce-scattered: after log2(KL)
  // exchanges lane kl holds the full sums of columns kl*TN/KL ..
  // (kl+1)*TN/KL - 1, so neighbouring lanes store neighbouring columns.
  // Otherwise (one column per thread) lane 0 of the group sums them all.
  template <typename Out>
  __device__ __forceinline__ void store(int nrows, int ncols, Out out) {
    constexpr bool SCATTER = TN % KL == 0;
    constexpr int CNT = NV;
    const int kl = threadIdx.x % KL, cg = (threadIdx.x / KL) % CS,
              rg = threadIdx.x / (KL * CS);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (SCATTER) {
        int w = TN;
#pragma unroll
        for (int off = KL / 2; off > 0; off /= 2) {
          const bool up = (kl & off) != 0;
          const int h = w / 2;
#pragma unroll
          for (int j = 0; j < TN / 2; ++j) {
            if (j >= h) break;
            const TX send = up ? acc[i][j] : acc[i][j + h];
            const TX keep = up ? acc[i][j + h] : acc[i][j];
            acc[i][j] = keep + shfl_xor(send, off);
          }
          w = h;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int off = KL / 2; off > 0; off /= 2)
            acc[i][j] += shfl_xor(acc[i][j], off);
      }
      const int r = rg + RS * i;
      const int c = cg * TN + (SCATTER ? kl * CNT : 0);
      if ((SCATTER || kl == 0) && r < nrows && c < ncols)
        out(r, c, acc[i], (ncols - c < CNT) ? ncols - c : CNT);
    }
  }
};

// Write cnt <= N consecutive values to dst: one 16-byte store when they
// fill one and `vec` says dst is 16-byte aligned, else one at a time.
// (N is the caller's compile-time bound, so v stays in registers.)
template <int N, typename TX>
__device__ __forceinline__ void put(TX* dst, const TX* v, int cnt,
                                    bool vec) {
  if constexpr (N * sizeof(TX) >= 16 && !IsComplex<TX>::value) {
    if (vec && cnt * sizeof(TX) == 16) {
      if constexpr (std::is_same<TX, float>::value)
        *reinterpret_cast<float4*>(dst) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < cnt) dst[k] = v[k];
}

// C[n] = A[n] * B[n] for every front n of the batch: A (M x K, row
// stride a_sr, front stride a_sf; TP), B (K x R, row-major, front
// stride b_sf; TX), C (M x R, row-major, front stride c_sf; TX).
// Grid: x = front * tiles_n + column tile (the column tiles of one row
// tile run side by side and share its panel rows in L2), y = row tile.
// ns: ring stages (Ring::N, or fewer when the depth has fewer tiles, so
// a shallow product holds less shared memory and more CTAs fit an SM).
// vec_a / vec_b / vec_c: the rows of A / B / C start on 16-byte
// boundaries.
template <typename TP, typename TX, int BN>
__global__ void __launch_bounds__(NT)
tile_product(const TP* __restrict__ A, int64_t a_sf, int64_t a_sr,
             const TX* __restrict__ B, int64_t b_sf, TX* __restrict__ C,
             int64_t c_sf, int M, int K, int R, int tiles_n, int ns,
             bool vec_a, bool vec_b, bool vec_c) {
  using L = Layout<TX, BN>;
  constexpr int BM = L::BM, BK = L::BK, LDA = L::LDA, LDB = L::LDB;
  constexpr int ST = Ring<TX, BN>::N;
  using Core = typename std::conditional<UseMma<TX, BN>::value,
                                         MmaCore<TP, BN>,
                                         FmaCore<TP, TX, BN>>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TP* As = reinterpret_cast<TP*>(smem_raw);
  TX* Bs = reinterpret_cast<TX*>(smem_raw + ns * BM * LDA * sizeof(TP));

  const int64_t n = blockIdx.x / tiles_n;
  const int m0 = blockIdx.y * BM;
  const int c0 = (blockIdx.x % tiles_n) * BN;
  const int nrows = (M - m0 < BM) ? M - m0 : BM;
  const int ncols = (R - c0 < BN) ? R - c0 : BN;
  const TP* Ag = A + n * a_sf + static_cast<int64_t>(m0) * a_sr;
  const TX* Bg = B + n * b_sf + c0;
  // this CTA's share of the depth tiles (all of them unless split)
  const int S = gridDim.z;
  const int nk_all = static_cast<int>(ceil_div(K, BK));
  const int per = static_cast<int>(ceil_div(nk_all, S));
  const int kt0 = blockIdx.z * per;
  const int nk = (nk_all - kt0 < per) ? (nk_all - kt0 > 0 ? nk_all - kt0 : 0)
                                      : per;

  auto load = [&](int kt) {
    const int slot = kt % ns, k0 = (kt0 + kt) * BK;
    stage_tile<TP, BM, BK, LDA>(As + slot * BM * LDA, Ag + k0, a_sr, nrows,
                                K - k0, vec_a);
    stage_tile<TX, BK, BN, LDB>(Bs + slot * BK * LDB,
                                Bg + static_cast<int64_t>(k0) * R, R,
                                K - k0, ncols, vec_b);
  };

  Core core;
  core.zero();
  // ns < ST only when nk < ST: then the prologue loads every
  // tile and the loop loads none
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<ST - 2>();
    __syncthreads();  // stage kt landed; stage kt-1's slot is free
    if (kt + ST - 1 < nk) load(kt + ST - 1);
    cp_commit();
    const int slot = kt % ns;
    core.step(As + slot * BM * LDA, Bs + slot * BK * LDB);
  }
  TX* Cg = C + n * c_sf + static_cast<int64_t>(m0) * R + c0;
  if (S == 1) {
    core.store(nrows, ncols, [&](int r, int c, const TX* v, int cnt) {
      put<Core::NV>(Cg + static_cast<int64_t>(r) * R + c, v, cnt, vec_c);
    });
    return;
  }
  // depth split over the S CTAs of a cluster: each leaves its partial
  // tile in its shared memory, then CTA `rank` sums its share of the
  // tile's elements over the S partials in rank order (deterministic)
  cp_wait<0>();
  __syncthreads();
  TX* Ps = reinterpret_cast<TX*>(smem_raw);  // BM x BN partial sums
  core.store(BM, BN, [&](int r, int c, const TX* v, int cnt) {
    put<Core::NV>(Ps + r * BN + c, v, cnt, false);
  });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * NT + threadIdx.x; e < BM * BN; e += S * NT) {
    const int r = e / BN, c = e % BN;
    if (r >= nrows || c >= ncols) continue;
    TX v = TX(0);
    for (int p = 0; p < S; ++p) v += cluster.map_shared_rank(Ps, p)[e];
    Cg[static_cast<int64_t>(r) * R + c] = v;
  }
  cluster.sync();  // no peer still reads this CTA's partial
}

// One right-hand side on the wide fronts: C[n][m] = A[n][m, :] . B[n]
// for every row, streamed straight into registers.  A warp takes RW
// consecutive rows of one front; each lane reads 16 bytes of each row
// per step (E panel values), so RW loads per lane are in flight and the
// matching E values of B, read once, serve all RW rows.  The row sums
// end with a shuffle reduction.  No shared memory, so an SM holds 16
// CTAs and their loads.
constexpr int RW = 4;

template <typename TP, typename TX>
__global__ void __launch_bounds__(NT)
row_dots(const TP* __restrict__ A, int64_t a_sf, int64_t a_sr,
         const TX* __restrict__ B, int64_t b_sf, TX* __restrict__ C,
         int64_t c_sf, int M, int K, int64_t chunks, int per_front,
         bool vec_a) {
  constexpr int E = 16 / static_cast<int>(sizeof(TP));
  const int64_t wg = (static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x) / 32;
  if (wg >= chunks) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int64_t n = wg / per_front;
  const int m0 = static_cast<int>(wg % per_front) * RW;
  const TP* Ar = A + n * a_sf + static_cast<int64_t>(m0) * a_sr;
  const TX* x = B + n * b_sf;
  TX acc[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) acc[i] = TX(0);
  int k0 = lane * E;
  if (vec_a && m0 + RW <= M) {
    // whole 16-byte steps of RW whole rows: no branch between the loads
#pragma unroll 4
    for (; k0 + E <= K; k0 += 32 * E) {
      TX xv[E];
      TP a[RW][E];
#pragma unroll
      for (int e = 0; e < E; ++e) xv[e] = x[k0 + e];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const TP* p = Ar + i * a_sr + k0;
        if constexpr (IsComplex<TP>::value) {
#pragma unroll
          for (int e = 0; e < E; ++e) a[i][e] = p[e];
        } else if constexpr (E == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
        } else {
          const double2 v = *reinterpret_cast<const double2*>(p);
          a[i][0] = v.x, a[i][1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i] += static_cast<TX>(a[i][e]) * xv[e];
    }
  }
  // the rest: the last partial step, the last rows of the front, or
  // rows that are not 16-byte aligned, one value at a time
  for (; k0 < K; k0 += 32 * E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (k0 + e >= K) break;
      const TX xe = x[k0 + e];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (m0 + i < M)
          acc[i] += static_cast<TX>(Ar[i * a_sr + k0 + e]) * xe;
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[i] += shfl_xor(acc[i], off);
    if (lane == 0 && m0 + i < M) C[n * c_sf + m0 + i] = acc[i];
  }
}

// Narrow fronts (wb <= BM and wb <= KY): one launch, one CTA per
// (front, column tile).  The CTA stages its x tile (all wb rows) in
// shared memory, computes y = Li*x into Y and over x in place, and then
// streams the rows of L21 through the ring against that resident y.  The
// ring runs over (row tile, depth tile) pairs, the y tile first, so the
// next tile's panel rows are in flight while the current one is
// multiplied; y never leaves the chip between the two products.
constexpr int KY = 64;  // rows of the resident x / y tile

template <typename TP, typename TX, int BN>
__global__ void __launch_bounds__(NT)
lsum_fused(const TP* __restrict__ Li, int64_t li_sf, int64_t li_sr,
           const TP* __restrict__ L21, int64_t l21_sf, int64_t l21_sr,
           const TX* __restrict__ xb, TX* __restrict__ Y,
           TX* __restrict__ UPD, int wb, int rtrim, int R, int tiles_n,
           bool vec_li, bool vec_l21, bool vec_x, bool vec_y,
           bool vec_u) {
  using L = Layout<TX, BN>;
  constexpr int BM = L::BM, BK = L::BK, LDA = L::LDA, LDB = L::LDB;
  using Core = typename std::conditional<UseMma<TX, BN>::value,
                                         MmaCore<TP, BN>,
                                         FmaCore<TP, TX, BN>>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TP* As = reinterpret_cast<TP*>(smem_raw);
  TX* Ys = reinterpret_cast<TX*>(smem_raw + STAGES * BM * LDA * sizeof(TP));

  const int64_t n = blockIdx.x / tiles_n;
  const int c0 = (blockIdx.x % tiles_n) * BN;
  const int ncols = (R - c0 < BN) ? R - c0 : BN;
  const int nk = static_cast<int>(ceil_div(wb, BK));
  const int nst = (1 + static_cast<int>(ceil_div(rtrim, BM))) * nk;
  const TP* Lig = Li + n * li_sf;
  const TP* L21g = L21 + n * l21_sf;

  // stage s: row tile u = s / nk (0: Li, u > 0: rows (u-1)*BM.. of
  // L21), depth tile s % nk
  auto load = [&](int s) {
    const int u = s / nk, k0 = (s % nk) * BK;
    const TP* src = Lig;
    int64_t sr = li_sr;
    int rows = wb;
    if (u > 0) {
      const int m0 = (u - 1) * BM;
      src = L21g + static_cast<int64_t>(m0) * l21_sr;
      sr = l21_sr;
      rows = (rtrim - m0 < BM) ? rtrim - m0 : BM;
    }
    stage_tile<TP, BM, BK, LDA>(As + (s % STAGES) * BM * LDA, src + k0, sr,
                                rows, wb - k0, u == 0 ? vec_li : vec_l21);
  };
  // x (zero past wb rows and ncols columns) travels with stage 0
  stage_tile<TX, KY, BN, LDB>(Ys, xb + n * wb * R + c0, R, wb, ncols, vec_x);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  Core core;
  core.zero();
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s-1's slot is free
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const int u = s / nk, kt = s % nk;
    core.step(As + (s % STAGES) * BM * LDA, Ys + kt * BK * LDB);
    if (kt != nk - 1) continue;
    if (u == 0) {
      __syncthreads();  // every warp is done reading x: y replaces it
      TX* Yg = Y + n * wb * R + c0;
      core.store(wb, ncols, [&](int r, int c, const TX* v, int cnt) {
        put<Core::NV>(Yg + static_cast<int64_t>(r) * R + c, v, cnt, vec_y);
        put<Core::NV>(Ys + r * LDB + c, v, cnt, false);
      });
    } else {
      const int m0 = (u - 1) * BM;
      TX* Ug = UPD + (n * rtrim + m0) * R + c0;
      core.store((rtrim - m0 < BM) ? rtrim - m0 : BM, ncols,
                 [&](int r, int c, const TX* v, int cnt) {
                   put<Core::NV>(Ug + static_cast<int64_t>(r) * R + c, v, cnt,
                                 vec_u);
                 });
    }
    core.zero();
  }
}

bool aligned16(const void* p, int64_t stride0, int64_t stride1,
               size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (stride0 * static_cast<int64_t>(elem)) % 16 == 0 &&
         (stride1 * static_cast<int64_t>(elem)) % 16 == 0;
}

// CTAs below which a product splits its depth over a cluster
constexpr int64_t FEW = 2 * 132;
constexpr int MAX_SPLIT = 8;  // the portable cluster size

template <typename TP, typename TX, int BN>
int product(const TP* A, int64_t a_sf, int64_t a_sr, const TX* B,
            int64_t b_sf, TX* C, int64_t c_sf, int64_t t, int64_t M,
            int64_t K, int64_t R, cudaStream_t stream) {
  using L = Layout<TX, BN>;
  const int64_t tiles_m = ceil_div(M, L::BM), tiles_n = ceil_div(R, BN);
  if (tiles_m > 65535 || t * tiles_n > INT32_MAX || M > INT32_MAX ||
      K > INT32_MAX || R > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // few output tiles (the wide fronts near the root): split the depth
  // so that enough CTAs stream the panels, each over fewer stages
  const int64_t nk_all = ceil_div(K, L::BK);
  int S = 1;
  while (S < MAX_SPLIT && 2 * S <= nk_all && t * tiles_m * tiles_n * S < FEW)
    S *= 2;
  const int64_t per = ceil_div(nk_all, S);
  constexpr int ST = Ring<TX, BN>::N;
  const int ns = static_cast<int>(per < ST ? per : ST);
  size_t smem = ns * (static_cast<size_t>(L::BM) * L::LDA * sizeof(TP) +
                      static_cast<size_t>(L::BK) * L::LDB * sizeof(TX));
  if (S > 1 && smem < L::BM * BN * sizeof(TX)) smem = L::BM * BN * sizeof(TX);
  auto kern = tile_product<TP, TX, BN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec_a = aligned16(A, a_sf, a_sr, sizeof(TP));
  const bool vec_b = aligned16(B, b_sf, R, sizeof(TX));
  const bool vec_c = aligned16(C, c_sf, R, sizeof(TX));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(t * tiles_n), (unsigned)tiles_m, (unsigned)S);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = (S > 1) ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, A, a_sf, a_sr, B, b_sf, C,
                                     c_sf, (int)M, (int)K, (int)R,
                                     (int)tiles_n, ns, vec_a, vec_b, vec_c);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TX>
int dots(const TP* A, int64_t a_sf, int64_t a_sr, const TX* B, int64_t b_sf,
         TX* C, int64_t c_sf, int64_t t, int64_t M, int64_t K,
         cudaStream_t s) {
  if (M > INT32_MAX || K > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_front = ceil_div(M, RW), chunks = t * per_front;
  const int64_t blocks = ceil_div(chunks, NT / 32);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  row_dots<TP, TX><<<(unsigned)blocks, NT, 0, s>>>(
      A, a_sf, a_sr, B, b_sf, C, c_sf, (int)M, (int)K, chunks,
      (int)per_front, aligned16(A, a_sf, a_sr, sizeof(TP)));
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TX, int BN>
int fused(const TP* Li, int64_t li_sf, int64_t li_sr, const TP* L21,
          int64_t l21_sf, int64_t l21_sr, const TX* xb, TX* y, TX* upd,
          int64_t t, int64_t wb, int64_t rtrim, int64_t R, cudaStream_t s) {
  using L = Layout<TX, BN>;
  const int64_t tiles_n = ceil_div(R, BN);
  if (t * tiles_n > INT32_MAX || rtrim > INT32_MAX || R > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = STAGES * static_cast<size_t>(L::BM) * L::LDA *
                          sizeof(TP) +
                      static_cast<size_t>(KY) * L::LDB * sizeof(TX);
  auto kern = lsum_fused<TP, TX, BN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<(unsigned)(t * tiles_n), NT, smem, s>>>(
      Li, li_sf, li_sr, L21, l21_sf, l21_sr, xb, y, upd, (int)wb,
      (int)rtrim, (int)R, (int)tiles_n, aligned16(Li, li_sf, li_sr, sizeof(TP)),
      aligned16(L21, l21_sf, l21_sr, sizeof(TP)),
      aligned16(xb, wb * R, R, sizeof(TX)), aligned16(y, wb * R, R, sizeof(TX)),
      aligned16(upd, rtrim * R, R, sizeof(TX)));
  return static_cast<int>(cudaGetLastError());
}

// the fused launch for narrow fronts when they alone fill the card,
// else the two products
template <typename TP, typename TX, int BN>
int lsum_pair(const TP* li, int64_t li_sf, int64_t li_sr, const TP* l21,
              int64_t l21_sf, int64_t l21_sr, const TX* x, TX* y, TX* u,
              int64_t t, int64_t wb, int64_t rtrim, int64_t R,
              cudaStream_t s) {
  if (wb <= Tile<BN>::BM && wb <= KY && t * ceil_div(R, BN) >= FEW)
    return fused<TP, TX, BN>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y, u,
                             t, wb, rtrim, R, s);
  // y = Li*xb into Y, then upd = L21*y (y read back from Y) into UPD
  if constexpr (BN == 1) {
    int rc = dots<TP, TX>(li, li_sf, li_sr, x, wb, y, wb, t, wb, wb, s);
    if (rc != 0 || rtrim <= 0) return rc;
    return dots<TP, TX>(l21, l21_sf, l21_sr, y, wb, u, rtrim, t, rtrim, wb,
                        s);
  } else {
    int rc = product<TP, TX, BN>(li, li_sf, li_sr, x, wb * R, y, wb * R, t,
                                 wb, wb, R, s);
    if (rc != 0 || rtrim <= 0) return rc;
    return product<TP, TX, BN>(l21, l21_sf, l21_sr, y, wb * R, u, rtrim * R,
                               t, rtrim, wb, R, s);
  }
}

template <typename TP, typename TX>
int run(void* Li, int64_t li_sf, int64_t li_sr, void* L21, int64_t l21_sf,
        int64_t l21_sr, void* xb, void* Y, void* UPD, int64_t t, int64_t wb,
        int64_t rtrim, int64_t R, int64_t y_off, int64_t u_off,
        void* stream) {
  if (t <= 0 || R <= 0 || wb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TP* li = static_cast<const TP*>(Li);
  const TP* l21 = static_cast<const TP*>(L21);
  TX* y = static_cast<TX*>(Y) + y_off * R;
  TX* u = static_cast<TX*>(UPD) + u_off * R;
  const TX* x = static_cast<const TX*>(xb);
  // 1, 4, 16 or 64 right-hand sides per CTA (more columns tile the grid;
  // at most 16 on the complex lanes)
  if (R == 1)
    return lsum_pair<TP, TX, 1>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y,
                                u, t, wb, rtrim, R, s);
  if (R <= 4)
    return lsum_pair<TP, TX, 4>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y,
                                u, t, wb, rtrim, R, s);
  if (R <= 16 || IsComplex<TX>::value)
    return lsum_pair<TP, TX, 16>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y,
                                 u, t, wb, rtrim, R, s);
  if constexpr (!IsComplex<TX>::value)
    return lsum_pair<TP, TX, 64>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x,
                                 y, u, t, wb, rtrim, R, s);
  return 0;
}

// ------------------------------------------------------ bfloat16 panels

// bfloat16 panels (a bfloat16 factorization) with float32 or float64
// right-hand sides:
//   * up to 4 right-hand sides, `bf16_rows`: two launches, y = Li*x
//     into Y, then upd = L21*y with y read back from Y; one warp per
//     output row, its lanes over the depth (coalesced panel reads, each
//     value widened as it is read), the lanes' partial sums reduced by
//     shuffles in a fixed order;
//   * more: the panels widened once into a float32 workspace (exact),
//     then the float32-panel lanes above (f32_f32, f32_f64), whose
//     tiles reuse each panel value across the right-hand sides.
// Deterministic; no cp.async on bfloat16 (it has no 2-byte copies).
constexpr int BF_NT = 256;     // 8 warps
constexpr int BF_ROWS = BF_NT / 32;
constexpr int64_t BF_WIDEN_CTAS = 132 * 8;   // grid-stride widening

// C[n][r, c0 + j] = A[n][r, :] . B[n][:, c0 + j] for j < CB: A (M x K,
// row stride a_sr, front stride a_sf; bfloat16), B (K x R row-major,
// front stride b_sf), C (M x R row-major, front stride c_sf).  Grid:
// x = row block, y = front (from f0), z = column tile.
template <typename TX, int CB>
__global__ void __launch_bounds__(BF_NT)
bf16_rows(const bf16* __restrict__ A, int64_t a_sf, int64_t a_sr,
          const TX* __restrict__ B, int64_t b_sf, TX* __restrict__ C,
          int64_t c_sf, int M, int K, int R, int64_t f0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * BF_ROWS + warp;
  if (r >= M) return;                    // whole warps leave together
  const int64_t n = f0 + blockIdx.y;
  const int c0 = blockIdx.z * CB;
  const int nc = (R - c0 < CB) ? R - c0 : CB;
  const bf16* a = A + n * a_sf + static_cast<int64_t>(r) * a_sr;
  const TX* b = B + n * b_sf + c0;
  TX acc[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) acc[j] = TX(0);
  for (int k = lane; k < K; k += 32) {
    const TX av = static_cast<TX>(widen(a[k]));
    const TX* bk = b + static_cast<int64_t>(k) * R;
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (j < nc) acc[j] += av * bk[j];
  }
#pragma unroll
  for (int j = 0; j < CB; ++j)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc[j] += shfl_xor(acc[j], off);
  if (lane == 0) {
    TX* cr = C + n * c_sf + static_cast<int64_t>(r) * R + c0;
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (j < nc) cr[j] = acc[j];
  }
}

// CB: right-hand sides per warp of bf16_rows (1 or 4)
template <typename TX, int CB>
int bf16_product(const bf16* A, int64_t a_sf, int64_t a_sr, const TX* B,
                 int64_t b_sf, TX* C, int64_t c_sf, int64_t t, int64_t M,
                 int64_t K, int64_t R, cudaStream_t s) {
  if (M <= 0) return 0;
  const int64_t rows = ceil_div(M, BF_ROWS), tiles = ceil_div(R, CB);
  if (rows > INT32_MAX || tiles > 65535 || M > INT32_MAX ||
      K > INT32_MAX || R > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t f0 = 0; f0 < t; f0 += 65535) {
    const int64_t nf = (t - f0 < 65535) ? t - f0 : 65535;
    const dim3 grid((unsigned)rows, (unsigned)nf, (unsigned)tiles);
    bf16_rows<TX, CB><<<grid, BF_NT, 0, s>>>(A, a_sf, a_sr, B, b_sf, C,
                                             c_sf, (int)M, (int)K, (int)R,
                                             f0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename TX, int CB>
int lsum_bf16_pair(const bf16* li, int64_t li_sf, int64_t li_sr,
                   const bf16* l21, int64_t l21_sf, int64_t l21_sr,
                   const TX* x, TX* y, TX* u, int64_t t, int64_t wb,
                   int64_t rtrim, int64_t R, cudaStream_t s) {
  int rc = bf16_product<TX, CB>(li, li_sf, li_sr, x, wb * R, y, wb * R, t,
                                wb, wb, R, s);
  if (rc != 0 || rtrim <= 0) return rc;
  return bf16_product<TX, CB>(l21, l21_sf, l21_sr, y, wb * R, u, rtrim * R,
                              t, rtrim, wb, R, s);
}

// dst (t, M, K) contiguous float32 <- src (t, M, K) bfloat16 with front
// stride sf and row stride sr
__global__ void __launch_bounds__(BF_NT)
widen_panels(const bf16* __restrict__ src, int64_t sf, int64_t sr,
             float* __restrict__ dst, int64_t t, int64_t M, int64_t K) {
  const int64_t total = t * M * K;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(BF_NT) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * BF_NT) {
    const int64_t n = i / (M * K), rk = i - n * M * K;
    const int64_t r = rk / K, k = rk - r * K;
    dst[i] = widen(src[n * sf + r * sr + k]);
  }
}

int widen_to_f32(const bf16* src, int64_t sf, int64_t sr, float* dst,
                 int64_t t, int64_t M, int64_t K, cudaStream_t s) {
  const int64_t total = t * M * K;
  if (total <= 0) return 0;
  const int64_t ctas = ceil_div(total, BF_NT);
  widen_panels<<<(unsigned)(ctas < BF_WIDEN_CTAS ? ctas : BF_WIDEN_CTAS),
                 BF_NT, 0, s>>>(src, sf, sr, dst, t, M, K);
  return static_cast<int>(cudaGetLastError());
}

// `work`: float32, t * (wb + rtrim) * wb elements, used above 4
// right-hand sides (may be null at or below; ops/lsum.BF16_ROWS_MAX)
template <typename TX>
int run_bf16(void* Li, int64_t li_sf, int64_t li_sr, void* L21,
             int64_t l21_sf, int64_t l21_sr, void* xb, void* Y, void* UPD,
             void* work, int64_t t, int64_t wb, int64_t rtrim, int64_t R,
             int64_t y_off, int64_t u_off, void* stream) {
  if (t <= 0 || R <= 0 || wb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* li = static_cast<const bf16*>(Li);
  const bf16* l21 = static_cast<const bf16*>(L21);
  if (R > 4) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    float* wli = static_cast<float*>(work);
    float* wl21 = wli + t * wb * wb;
    int rc = widen_to_f32(li, li_sf, li_sr, wli, t, wb, wb, s);
    if (rc == 0 && rtrim > 0)
      rc = widen_to_f32(l21, l21_sf, l21_sr, wl21, t, rtrim, wb, s);
    if (rc != 0) return rc;
    return run<float, TX>(wli, wb * wb, wb, wl21, rtrim * wb, wb, xb, Y,
                          UPD, t, wb, rtrim, R, y_off, u_off, stream);
  }
  const TX* x = static_cast<const TX*>(xb);
  TX* y = static_cast<TX*>(Y) + y_off * R;
  TX* u = static_cast<TX*>(UPD) + u_off * R;
  if (R == 1)
    return lsum_bf16_pair<TX, 1>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x,
                                 y, u, t, wb, rtrim, R, s);
  return lsum_bf16_pair<TX, 4>(li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y,
                               u, t, wb, rtrim, R, s);
}

}  // namespace

#define SLU_LSUM_EXPORT_BF16(NAME, TX)                                     \
  extern "C" int NAME(void* Li, int64_t li_sf, int64_t li_sr, void* L21, \
                      int64_t l21_sf, int64_t l21_sr, void* xb, void* Y,  \
                      void* UPD, void* work, int64_t t, int64_t wb,       \
                      int64_t rtrim, int64_t R, int64_t y_off,            \
                      int64_t u_off, void* stream) {                      \
    return run_bf16<TX>(Li, li_sf, li_sr, L21, l21_sf, l21_sr, xb, Y,    \
                        UPD, work, t, wb, rtrim, R, y_off, u_off,         \
                        stream);                                          \
  }

SLU_LSUM_EXPORT_BF16(slu_lsum_bf16_f32, float)
SLU_LSUM_EXPORT_BF16(slu_lsum_bf16_f64, double)

#define SLU_LSUM_EXPORT(NAME, TP, TX)                                      \
  extern "C" int NAME(void* Li, int64_t li_sf, int64_t li_sr, void* L21, \
                      int64_t l21_sf, int64_t l21_sr, void* xb, void* Y,  \
                      void* UPD, int64_t t, int64_t wb, int64_t rtrim,    \
                      int64_t R, int64_t y_off, int64_t u_off,            \
                      void* stream) {                                     \
    return run<TP, TX>(Li, li_sf, li_sr, L21, l21_sf, l21_sr, xb, Y, UPD, \
                       t, wb, rtrim, R, y_off, u_off, stream);            \
  }

SLU_LSUM_EXPORT(slu_lsum_f32_f32, float, float)
SLU_LSUM_EXPORT(slu_lsum_f64_f64, double, double)
SLU_LSUM_EXPORT(slu_lsum_f32_f64, float, double)
SLU_LSUM_EXPORT(slu_lsum_c64_c64, c64, c64)
SLU_LSUM_EXPORT(slu_lsum_c128_c128, c128, c128)
SLU_LSUM_EXPORT(slu_lsum_c64_c128, c64, c128)
