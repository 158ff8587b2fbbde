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
//
// Design: records are sorted by parent front; the host precomputes each
// front's record range [seg[f], seg[f+1]).  Grid (front, row band of 32
// destination rows): a CTA walks its front's children in record order
// with a barrier between children, one warp per child row (rows outside
// the band are skipped), lanes over the child's columns.  Within one
// child the destination positions are distinct, bands are disjoint, and
// children are applied in order, so there are no atomics and the result
// is deterministic.
#include "common.cuh"

namespace {

constexpr int BAND = 32;   // destination rows per CTA

template <typename T>
__global__ void __launch_bounds__(256)
ea_scatter_kernel(T* __restrict__ F, const T* __restrict__ upd,
                  const int64_t* __restrict__ so,
                  const int64_t* __restrict__ st,
                  const int64_t* __restrict__ pr,
                  const int64_t* __restrict__ fronts,
                  const int64_t* __restrict__ seg, int64_t rc_b,
                  int64_t mb) {
  const int64_t fi = blockIdx.x;
  const int64_t front = fronts[fi];
  const int64_t r0 = (int64_t)blockIdx.y * BAND;
  const int64_t r1 = (r0 + BAND < mb) ? r0 + BAND : mb;
  T* Ff = F + front * mb * mb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int64_t rec_end = seg[fi + 1];
  for (int64_t rec = seg[fi]; rec < rec_end; ++rec) {
    const int64_t* p = pr + rec * rc_b;
    const int64_t s0 = so[rec], sst = st[rec];
    for (int64_t i = warp; i < rc_b; i += nwarps) {
      const int64_t pi = p[i];
      if (pi < r0 || pi >= r1) continue;   // other band, or sentinel
      const T* src = upd + s0 + i * sst;
      T* dst = Ff + pi * mb;
      for (int64_t j = lane; j < rc_b; j += 32) {
        const int64_t pj = p[j];
        if (pj < mb) dst[pj] += src[j];
      }
    }
    __syncthreads();   // children in record order
  }
}

template <typename T>
int run(void* F, void* upd, void* so, void* st, void* pr, void* fronts,
        void* seg, int64_t nfronts, int64_t rc_b, int64_t mb,
        void* stream) {
  if (nfronts <= 0) return 0;
  const dim3 grid((unsigned)nfronts, (unsigned)ceil_div(mb, BAND));
  ea_scatter_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(F), static_cast<const T*>(upd),
      static_cast<const int64_t*>(so), static_cast<const int64_t*>(st),
      static_cast<const int64_t*>(pr),
      static_cast<const int64_t*>(fronts),
      static_cast<const int64_t*>(seg), rc_b, mb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int slu_ea_scatter_f32(void* F, void* upd, void* so, void* st,
                                  void* pr, void* fronts, void* seg,
                                  int64_t nfronts, int64_t rc_b,
                                  int64_t mb, void* stream) {
  return run<float>(F, upd, so, st, pr, fronts, seg, nfronts, rc_b, mb,
                    stream);
}

extern "C" int slu_ea_scatter_f64(void* F, void* upd, void* so, void* st,
                                  void* pr, void* fronts, void* seg,
                                  int64_t nfronts, int64_t rc_b,
                                  int64_t mb, void* stream) {
  return run<double>(F, upd, so, st, pr, fronts, seg, nfronts, rc_b, mb,
                     stream);
}
