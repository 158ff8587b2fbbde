// Kernel K2: extend-add of one element bucket, added in place into the
// group's front batch.
//
// Replaces the Pallas kernel of the reference package,
// superlu_dist_tpu/ops/pallas_scatter.py (`scatter_add_delta`, body
// `_scatter_kernel`), reached from ops/batched._ea_add.  For each child
// record k of a bucket: the child's rc_b x rc_b update block sits in the
// flat slab `upd` at so[k] + i*st[k] + j, and element (i, j) is added to
// its parent front at (pr[k, i], pr[k, j]).  A position equal to mb is a
// padding sentinel and is dropped; it is tested before the slab is read,
// since the source index of a padding lane can run past the slab.
//
// The reference gathered the child blocks first, then (on the TPU, which
// has no scatter datapath) expanded them with one-hot matrix products
// into a delta array the caller added to the fronts.  Here the gather is
// folded into the kernel and the adds go straight into the fronts, in
// place: no delta array, no gathered copy.
//
// What bounds it on an H100: bytes.  Each live lane reads one slab value
// and reads and writes one front value, with no arithmetic to speak of.
// For narrow children (rc_b <= 32, most buckets) the time is latency:
// a front receives a handful of children of a few dozen values each,
// so what counts is the number of dependent trips to memory.
//
// Complex lanes (complex64 / complex128): the same kernels on the complex
// type of common.cuh, a complex add at each destination.  The bfloat16
// lane (the factor sweep of a bfloat16 factorization) widens every value
// to float as it is read and rounds once at each store: a narrow
// destination's whole sum rounds once, a wide one once per record.
//
// Design.  No atomics, a deterministic result: every destination's
// values are added in record order.
//   * Narrow buckets (rc_b <= 32): the schedule builder derives, once
//     per schedule, each destination element's slab sources in record
//     order, the first two inline (ops/ea_scatter.destination_lists;
//     sentinel lanes are dropped there, before any slab index is kept).  One thread per
//     destination: the lists, then F and the slab values, then the
//     store.  Walking a front's children in order instead (one warp per
//     front) costs one trip per child, and the front with the most
//     children sets the kernel's time.
//   * Wide buckets: records sorted by parent front, with each front's
//     record range [seg[f], seg[f+1]).  One CTA per (parent front, band
//     of BAND rows).  For each child the CTA stages the row map in
//     shared memory as int32, finds the child rows that land in its band
//     by binary search (the map is strictly increasing up to its
//     sentinels, which lie above every band; the CPU tests assert it on
//     the schedule), and then one warp per child row adds the row, lanes
//     over columns, UNR slab and front values in flight per lane
//     (coalesced scalar loads: slab rows start at arbitrary offsets).
//     Within one child the destinations are distinct, bands are
//     disjoint, and children are applied in order with a barrier
//     between them.
#include "common.cuh"

namespace {

constexpr int NARROW_THREADS = 256;
constexpr int BAND = 32;         // destination rows per CTA, wide buckets
constexpr int WIDE_THREADS = 256;
constexpr int UNR = 4;           // values in flight per lane, wide rows

// Narrow buckets: one thread per destination element.  It reads F
// there, adds the child values that land there in record order, and
// writes F back: two dependent trips to memory (the lists, then F and
// the slab) for a destination with one or two values (all but a handful
// of them), two more for the rare third and later values.
template <typename T>
__global__ void __launch_bounds__(NARROW_THREADS)
ea_narrow(T* __restrict__ F, const T* __restrict__ upd,
          const int64_t* __restrict__ head_dst,
          const int64_t* __restrict__ head_src,
          const int64_t* __restrict__ head_src2,
          const int64_t* __restrict__ xptr,
          const int64_t* __restrict__ xsrc, int64_t nheads) {
  const int64_t h =
      static_cast<int64_t>(blockIdx.x) * NARROW_THREADS + threadIdx.x;
  if (h >= nheads) return;
  const int64_t d = head_dst[h], s0 = head_src[h], s1 = head_src2[h];
  const int64_t x0 = xptr[h], x1 = xptr[h + 1];
  // sums in acc_t<T> (float for bfloat16), one rounding at the store
  using A = acc_t<T>;
  const A f = widen(F[d]), v0 = widen(upd[s0]);
  const A v1 = (s1 >= 0) ? widen(upd[s1]) : A(0);
  A v = f + v0;
  if (s1 >= 0) v += v1;
  for (int64_t x = x0; x < x1; ++x) v += widen(upd[xsrc[x]]);
  F[d] = narrow<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
ea_wide(T* __restrict__ F, const T* __restrict__ upd,
        const int64_t* __restrict__ so, const int64_t* __restrict__ st,
        const int64_t* __restrict__ pr, const int64_t* __restrict__ fronts,
        const int64_t* __restrict__ seg, int rc_b, int64_t mb) {
  extern __shared__ int pos[];  // the child's row map, int32
  __shared__ int range[2];      // its rows in this band: [lo, hi)
  const int64_t fi = blockIdx.x;
  const int r0 = blockIdx.y * BAND;
  const int r1 = (r0 + BAND < mb) ? r0 + BAND : static_cast<int>(mb);
  T* Ff = F + fronts[fi] * mb * mb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NW = WIDE_THREADS / 32;
  const int64_t rec_end = seg[fi + 1];
  for (int64_t rec = seg[fi]; rec < rec_end; ++rec) {
    const int64_t* p = pr + rec * rc_b;
    for (int j = threadIdx.x; j < rc_b; j += WIDE_THREADS)
      pos[j] = static_cast<int>(p[j]);
    __syncthreads();
    if (threadIdx.x < 2) {
      // first row with position >= (r0, r1): the map is non-decreasing
      const int key = threadIdx.x ? r1 : r0;
      int lo = 0, hi = rc_b;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (pos[mid] < key) lo = mid + 1; else hi = mid;
      }
      range[threadIdx.x] = lo;
    }
    __syncthreads();
    const int i_lo = range[0], i_hi = range[1];
    const T* src0 = upd + so[rec];
    const int64_t sst = st[rec];
    for (int i = i_lo + warp; i < i_hi; i += NW) {
      const T* src = src0 + i * sst;
      T* dst = Ff + static_cast<int64_t>(pos[i]) * mb;
      for (int j0 = 0; j0 < rc_b; j0 += 32 * UNR) {
        int pj[UNR];
        T s[UNR], d[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int j = j0 + u * 32 + lane;
          pj[u] = (j < rc_b) ? pos[j] : static_cast<int>(mb);
          if (pj[u] < mb) {
            s[u] = src[j];
            d[u] = dst[pj[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (pj[u] < mb) dst[pj[u]] = narrow<T>(widen(d[u]) + widen(s[u]));
      }
    }
    __syncthreads();  // children in record order; pos is reused
  }
}

template <typename T>
int run(void* F, void* upd, void* so, void* st, void* pr, void* fronts,
        void* seg, int64_t nfronts, int64_t rc_b, int64_t mb,
        void* head_dst, void* head_src, void* head_src2, void* xptr,
        void* xsrc, int64_t nheads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* f = static_cast<T*>(F);
  const T* u = static_cast<const T*>(upd);
  if (head_dst != nullptr) {
    if (nheads <= 0) return 0;
    ea_narrow<T><<<(unsigned)ceil_div(nheads, NARROW_THREADS),
                   NARROW_THREADS, 0, s>>>(
        f, u, static_cast<const int64_t*>(head_dst),
        static_cast<const int64_t*>(head_src),
        static_cast<const int64_t*>(head_src2),
        static_cast<const int64_t*>(xptr), static_cast<const int64_t*>(xsrc),
        nheads);
    return static_cast<int>(cudaGetLastError());
  }
  if (nfronts <= 0 || rc_b <= 0) return 0;
  if (mb > INT32_MAX || rc_b > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rc_b * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ea_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned)nfronts, (unsigned)ceil_div(mb, BAND));
  ea_wide<T><<<grid, WIDE_THREADS, smem, s>>>(
      f, u, static_cast<const int64_t*>(so), static_cast<const int64_t*>(st),
      static_cast<const int64_t*>(pr), static_cast<const int64_t*>(fronts),
      static_cast<const int64_t*>(seg), (int)rc_b, mb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SLU_EA_EXPORT(NAME, T)                                            \
  extern "C" int NAME(void* F, void* upd, void* so, void* st, void* pr,  \
                      void* fronts, void* seg, int64_t nfronts,           \
                      int64_t rc_b, int64_t mb, void* head_dst,           \
                      void* head_src, void* head_src2, void* xptr,        \
                      void* xsrc, int64_t nheads, void* stream) {         \
    return run<T>(F, upd, so, st, pr, fronts, seg, nfronts, rc_b, mb,     \
                  head_dst, head_src, head_src2, xptr, xsrc, nheads,      \
                  stream);                                                \
  }

SLU_EA_EXPORT(slu_ea_scatter_bf16, bf16)
SLU_EA_EXPORT(slu_ea_scatter_f32, float)
SLU_EA_EXPORT(slu_ea_scatter_f64, double)
SLU_EA_EXPORT(slu_ea_scatter_c64, c64)
SLU_EA_EXPORT(slu_ea_scatter_c128, c128)
