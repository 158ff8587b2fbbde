// Kernel K3: the fused forward lsum step of one trisolve group.
//
// Replaces the Pallas kernel of the reference package,
// superlu_dist_tpu/ops/pallas_lsum.py (`lsum_panel`, body
// `_lsum_kernel`, member `fwd_member`), reached from ops/trisolve.sweep
// for non-transposed members.  For each front n of the group:
//     y   = Li[n] * xb[n]            (wb x wb) * (wb x R)
//     upd = L21[n][:rtrim] * y       (rtrim x wb) * (wb x R)
// with y kept in shared memory between the two products; y is written
// straight into the solve buffer Y at row y_off + n*wb and upd into the
// lsum buffer UPD at row u_off + n*rtrim (both row-major, R columns),
// replacing the reference's two dynamic_update_slice writes.
//
// The panels (TP) and the right-hand sides (TX) are separate template
// types: in refinement, float32 factors meet a float64 residual, and the
// products then run in float64 on the float32 panels without an
// up-cast copy of them.
//
// What bounds it on an H100: bytes.  Every panel element is read once
// per right-hand-side tile and used for 2*RT flops, so at small nrhs
// the kernel streams Li and L21 at the memory rate.  At large nrhs the
// shared-memory reads of y, one per multiply-add, are the limit.
//
// Design: grid (front, right-hand-side tile of RT <= 8 columns, chunk of
// L21 rows), 16 row groups per CTA.  A group of G lanes (G = 32, or 8
// for narrow panels) computes one output row of a tile: the lanes walk
// the panel row together, so each load instruction reads consecutive
// addresses, each lane keeps RT partial sums, and a shuffle reduction
// within the group ends the row.  The xb tile and the y tile live in
// shared memory transposed (RT x wb), so the lanes read them without
// bank conflicts.  A grid of (front, tile) alone would leave most SMs
// idle on the groups of one or two large fronts, so the host splits
// their L21 rows into chunks, and the chunks of one (front, tile) run as
// thread-block clusters of CL CTAs: each CTA of a cluster computes 1/CL
// of the rows of y, the cluster exchanges the slices through
// distributed shared memory, and every CTA then holds all of y for its
// chunk of L21.  y never leaves the chip, and a cluster reads Li once.
// The first cluster of each (front, tile) writes y to Y.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// threads per CTA: 16 row groups of G lanes (512 for wide panels)
template <int G>
__host__ __device__ constexpr int threads_for() { return 16 * G; }
constexpr int RTMAX = 8;       // right-hand sides per tile
constexpr int64_t TARGET_CTAS = 2 * 132;
constexpr int CL = 8;          // CTAs per cluster on chunked groups

template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off, G);
  return v;
}

// acc[r] = sum_w row[w] * v[r*wb + w] over the G lanes of a group (lane
// gl takes w = gl, gl+G, ...); every lane of the group ends with the
// sums.  Called by all lanes of the warp (ok = false: zeros).  The
// panel loads are issued U at a time before they are used, so each lane
// keeps U loads in flight instead of one.
template <typename TP, typename TX, int RT, int G>
__device__ __forceinline__ void row_times(const TP* __restrict__ row,
                                          const TX* __restrict__ v,
                                          int wb, int gl, bool ok,
                                          TX (&acc)[RT]) {
  constexpr int U = 8;
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = TX(0);
  if (ok) {
    int w = gl;
    for (; w + (U - 1) * G < wb; w += U * G) {
      TX a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = static_cast<TX>(row[w + u * G]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] += a[u] * v[r * wb + w + u * G];
    }
#pragma unroll 4
    for (; w < wb; w += G) {
      const TX a = static_cast<TX>(row[w]);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += a * v[r * wb + w];
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = group_sum<G>(acc[r]);
}

// One (front, tile, chunk) CTA.  CLUSTER: the CTAs of a (front, tile)
// form clusters of CL along the chunk axis and share the work of y.
template <typename TP, typename TX, int RT, int G, bool CLUSTER>
__global__ void __launch_bounds__(threads_for<G>())
lsum_kernel(const TP* __restrict__ Li, int64_t li_sf, int64_t li_sr,
            const TP* __restrict__ L21, int64_t l21_sf, int64_t l21_sr,
            const TX* __restrict__ xb, TX* __restrict__ Y,
            TX* __restrict__ UPD, int64_t wb, int64_t rtrim, int64_t R,
            int64_t CH, int64_t y_off, int64_t u_off) {
  constexpr int NT = threads_for<G>();
  constexpr int NG = NT / G;                  // rows per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int iwb = static_cast<int>(wb);
  TX* xs = reinterpret_cast<TX*>(smem_raw);   // RT x wb
  TX* ys = xs + RT * iwb;                     // RT x wb
  const int64_t n = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * RT;
  const int rt = static_cast<int>((R - c0 < RT) ? (R - c0) : RT);
  const int64_t chunk = blockIdx.z;
  // this CTA's rows of y: all of them, or its cluster rank's slice
  int rank = 0, csize = 1;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    csize = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int per = (iwb + csize - 1) / csize;
  const int v_lo = rank * per;
  const int v_hi = (v_lo + per < iwb) ? v_lo + per : iwb;
  const bool writes_y = chunk < csize;        // the first cluster
  for (int idx = threadIdx.x; idx < iwb * RT; idx += NT) {
    const int w = idx / RT, r = idx % RT;
    xs[r * iwb + w] = (r < rt) ? xb[(n * wb + w) * R + c0 + r] : TX(0);
  }
  __syncthreads();
  const int grp = threadIdx.x / G, gl = threadIdx.x % G;
  TX acc[RT];
  // y = Li * xb over [v_lo, v_hi) (every r < RT is written to ys;
  // columns past rt are 0)
  for (int v0 = v_lo; v0 < v_hi; v0 += NG) {
    const int v = v0 + grp;
    const bool ok = v < v_hi;
    row_times<TP, TX, RT, G>(Li + n * li_sf + v * li_sr, xs, iwb, gl, ok,
                             acc);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (ok && gl == r) {
        ys[r * iwb + v] = acc[r];
        if (writes_y && r < rt)
          Y[(y_off + n * wb + v) * R + c0 + r] = acc[r];
      }
    }
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                           // every slice is written
    for (int p = 0; p < csize; ++p) {
      if (p == rank) continue;
      const TX* peer = cluster.map_shared_rank(ys, p);
      const int lo = p * per;
      const int hi = (lo + per < iwb) ? lo + per : iwb;
      for (int idx = threadIdx.x; idx < RT * (hi - lo); idx += NT) {
        const int r = idx / (hi - lo), v = lo + idx % (hi - lo);
        ys[r * iwb + v] = peer[r * iwb + v];
      }
    }
    cluster.sync();                           // no peer reads remain
  } else {
    __syncthreads();
  }
  // upd = L21[s0:s1] * y
  const int64_t s0 = chunk * CH;
  const int64_t s1 = (s0 + CH < rtrim) ? s0 + CH : rtrim;
  for (int64_t q0 = s0; q0 < s1; q0 += NG) {
    const int64_t s = q0 + grp;
    const bool ok = s < s1;
    row_times<TP, TX, RT, G>(L21 + n * l21_sf + s * l21_sr, ys, iwb, gl,
                             ok, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (ok && gl == r && r < rt)
        UPD[(u_off + n * rtrim + s) * R + c0 + r] = acc[r];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TP, typename TX, int RT, int G>
int launch(const void* Li, int64_t li_sf, int64_t li_sr, const void* L21,
           int64_t l21_sf, int64_t l21_sr, const void* xb, void* Y,
           void* UPD, int64_t t, int64_t wb, int64_t rtrim, int64_t R,
           int64_t y_off, int64_t u_off, cudaStream_t stream) {
  const size_t smem = 2 * RT * wb * sizeof(TX);
  const int64_t ntiles = ceil_div(R, RT);
  const TP* li = static_cast<const TP*>(Li);
  const TP* l21 = static_cast<const TP*>(L21);
  const TX* x = static_cast<const TX*>(xb);
  TX* y = static_cast<TX*>(Y);
  TX* u = static_cast<TX*>(UPD);
  if (t * ntiles >= TARGET_CTAS || (rtrim <= 16 && wb <= 64)) {
    // enough CTAs without chunks, or too little work to split
    cudaError_t e = allow_smem(lsum_kernel<TP, TX, RT, G, false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((unsigned)t, (unsigned)ntiles, 1u);
    lsum_kernel<TP, TX, RT, G, false><<<grid, threads_for<G>(), smem,
                                        stream>>>(
        li, li_sf, li_sr, l21, l21_sf, l21_sr, x, y, u, wb, rtrim, R,
        rtrim, y_off, u_off);
    return static_cast<int>(cudaGetLastError());
  }
  // chunks of at least max(16, wb/CL) L21 rows, so that a CTA reads no
  // more of L21 than its slice of Li; their count rounds up to whole
  // clusters (a chunk past rtrim only computes its slice of y)
  // (a group without update rows still splits y over one cluster)
  const int64_t min_rows = (wb / CL > 16) ? wb / CL : 16;
  int64_t nchunks = ceil_div(TARGET_CTAS, t * ntiles);
  const int64_t most = (rtrim > 0) ? ceil_div(rtrim, min_rows) : 1;
  if (nchunks > most) nchunks = most;
  const int64_t CH = (rtrim > 0) ? ceil_div(rtrim, nchunks) : 1;
  nchunks = ceil_div(nchunks, CL) * CL;
  auto k = lsum_kernel<TP, TX, RT, G, true>;
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)t, (unsigned)ntiles, (unsigned)nchunks);
  cfg.blockDim = dim3(threads_for<G>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = CL;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k, li, li_sf, li_sr, l21, l21_sf, l21_sr, x,
                         y, u, wb, rtrim, R, CH, y_off, u_off);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TX, int G>
int pick_tile(const void* Li, int64_t li_sf, int64_t li_sr,
              const void* L21, int64_t l21_sf, int64_t l21_sr,
              const void* xb, void* Y, void* UPD, int64_t t, int64_t wb,
              int64_t rtrim, int64_t R, int64_t y_off, int64_t u_off,
              cudaStream_t s) {
  int RT = 1;                                   // power of two >= R, <= 8
  while (RT < R && RT < RTMAX) RT *= 2;
  // the xb and y tiles must fit the opt-in shared memory
  while (RT > 1 && 2 * wb * RT * (int64_t)sizeof(TX) > 200 * 1024) RT /= 2;
  if (2 * wb * RT * (int64_t)sizeof(TX) > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
#define SLU_LSUM_CASE(N)                                                 \
  case N:                                                                \
    return launch<TP, TX, N, G>(Li, li_sf, li_sr, L21, l21_sf, l21_sr,   \
                                xb, Y, UPD, t, wb, rtrim, R, y_off,      \
                                u_off, s);
  switch (RT) {
    SLU_LSUM_CASE(1)
    SLU_LSUM_CASE(2)
    SLU_LSUM_CASE(4)
    SLU_LSUM_CASE(8)
  }
#undef SLU_LSUM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TP, typename TX>
int run(void* Li, int64_t li_sf, int64_t li_sr, void* L21,
        int64_t l21_sf, int64_t l21_sr, void* xb, void* Y, void* UPD,
        int64_t t, int64_t wb, int64_t rtrim, int64_t R, int64_t y_off,
        int64_t u_off, void* stream) {
  if (t <= 0 || R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // narrow panels: 8 lanes per row, so a row's loads still fill them
  if (wb <= 64)
    return pick_tile<TP, TX, 8>(Li, li_sf, li_sr, L21, l21_sf, l21_sr, xb,
                                Y, UPD, t, wb, rtrim, R, y_off, u_off, s);
  return pick_tile<TP, TX, 32>(Li, li_sf, li_sr, L21, l21_sf, l21_sr, xb,
                               Y, UPD, t, wb, rtrim, R, y_off, u_off, s);
}

}  // namespace

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
