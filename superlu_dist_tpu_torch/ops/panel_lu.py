"""Kernel K1: the batched front partial LU (csrc/panel_lu.cu).

Replaces the reference's Pallas kernel
superlu_dist_tpu/ops/pallas_lu.py (`partial_lu_batch_pallas` →
`_pallas_lu_call`).  On a CUDA tensor `partial_lu_batch` launches the
kernel; on a CPU tensor it runs the plain version,
ops/dense_lu.partial_lu_batch, which computes the same function.  It
never falls back from one to the other: a CUDA tensor the kernel does
not take raises.

`launch_plan` picks the kernel's regime on the host from (N, mb, wb,
dtype) alone, so the choice is testable without a card:
  * "small" — the whole front fits SMALL_FRONT_BYTES: one launch
    (`lu_small`), the panel-and-strip cross of each front eliminated in
    shared memory and the Schur complement streamed once;
  * "large" — one `panel_step` launch per PANEL_BLOCK columns of the
    panel plus one, `panel_copy`, then `strip_solve` (U12) and one
    `schur_update` (F22 −= L21·U12 at depth wb, FP64 tensor cores in
    float64, complex FMAs on the complex lanes); a workspace keeps the inverses of the panel's diagonal
    blocks, so every triangular solve is a product, and the panel's L
    and U until the panel phase ends.
The shared-memory sizes and grids here mirror `run` in panel_lu.cu.

`partial_lu_batch.launches` counts the wrapper calls that launched the
kernel (one per group; `launch_plan(...).kernels` says how many CUDA
kernels each call runs), and `partial_lu_batch.lanes` the same calls
per lane (bf16, f32, f64, c64, c128).  The bf16 lane (a bfloat16
factorization) runs the f32 lane on a float32 copy of the fronts and
rounds the result once into them; its threshold is bfloat16's
(batched._thresh_for).

The kernel reads the GESP threshold on the device, from a one-element
float64 tensor: a CUDA graph that captured the call (ops/graphs.py)
then serves every threshold the host writes into that tensor before a
replay, where a threshold passed by value would stay the one captured.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from . import _cuda
from .dense_lu import partial_lu_batch as partial_lu_batch_plain

# a front of at most this many bytes runs whole in one CTA ("small");
# 128 KiB is a 128 x 128 float64 front, and its cross with the
# shared-memory padding stays under the 227 KiB a CTA may use
SMALL_FRONT_BYTES = 128 * 1024
WARP_MB = 32            # small fronts up to this size: one warp each
THREADS = 256           # threads per CTA in every kernel
PANEL_BLOCK = 64        # panel block depth of the large regime
ROW_TILE = 64           # rows per panel_step CTA
COL_TILE = 64           # columns per strip_solve CTA
UPDATE_TILE = (128, 128, 32, 3)  # schur_update BM, BN, BK, stages
UPDATE_TILE_COMPLEX = (64, 64, 16, 3)   # the same on the complex lanes
SMEM_LIMIT = 232_448    # bytes of shared memory a CTA may use (H100)
CONVERT_CTAS = 132 * 8  # grid of the bfloat16 lane's conversions
GRID_YZ_MAX = 65535

_REGIME_CODE = {"small": 0, "large": 1}

# the kernel's lane (the suffix of its launcher's name) per element type
LANES = {torch.bfloat16: "bf16", torch.float32: "f32",
         torch.float64: "f64", torch.complex64: "c64",
         torch.complex128: "c128"}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    regime: str                 # "small" or "large"
    kernels: int                # CUDA kernels per wrapper call
    smem_bytes: int             # the most dynamic shared memory of any
    grids: tuple                # ((x, y, z), ...) of every launch
    work_elems: int             # workspace elements (see run in .cu)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(N: int, mb: int, wb: int, dtype) -> LaunchPlan:
    """The regime, launches, shared memory and grids K1 uses for a
    (N, mb, mb) batch factored over its leading `wb` columns."""
    if dtype not in LANES:
        raise TypeError(f"partial_lu_batch: dtype {dtype} not supported")
    if not 1 <= wb <= mb:
        raise ValueError(f"partial_lu_batch: unsupported wb={wb}, mb={mb}")
    if dtype == torch.bfloat16:
        # the float32 lane on a float32 copy of the fronts, between a
        # widening and a narrowing pass (one grid-stride launch each)
        p = launch_plan(N, mb, wb, torch.float32)
        conv = ((min(_ceil(N * mb * mb, THREADS), CONVERT_CTAS), 1, 1),)
        return dataclasses.replace(
            p, kernels=p.kernels + 2, grids=conv + p.grids + conv,
            work_elems=N * mb * mb + p.work_elems)
    it = dtype.itemsize
    if mb * mb * it <= SMALL_FRONT_BYTES:
        if mb <= WARP_MB:        # a warp per front, in registers
            return LaunchPlan("small", 1, 0,
                              ((_ceil(N, THREADS // 32), 1, 1),), 0)
        # the cross in shared memory, rows padded by 16 bytes when
        # 16-byte aligned, else by one element
        e = 16 // it
        pad = e if mb % e == 0 and wb % e == 0 else 1
        smem = (mb * (wb + pad) + wb * (mb - wb + pad)) * it
        return LaunchPlan("small", 1, smem, ((N, 1, 1),), 0)
    pb, rt, ct = PANEL_BLOCK, ROW_TILE, COL_TILE
    bm, bn, bk, st = (UPDATE_TILE_COMPLEX if dtype.is_complex
                      else UPDATE_TILE)
    sm_panel = 3 * pb * (ct + 8) * it            # = strip_solve's
    sm_upd = st * (bm * (bk + 4) + bk * (bn + 8)) * it
    rb = mb - wb
    nblk = _ceil(wb, pb)
    grids = []
    for f0 in range(0, N, GRID_YZ_MAX):
        nf = min(N - f0, GRID_YZ_MAX)
        for j in range(nblk + 1):          # panel_step j
            rs = min(j * pb, wb)
            tiles = 1 if j == 0 else _ceil(mb - rs, rt)
            cols = 1 if j == 0 else max(nblk - j, 1)
            if tiles:
                grids.append((tiles, cols, nf))
        grids.append((_ceil(mb, rt), nf, 1))           # panel_copy
        if rb:
            grids.append((_ceil(rb, ct), nf, 1))       # strip_solve
            grids.append((_ceil(rb, bn), _ceil(rb, bm), nf))  # update
    # per front: the diagonal blocks' inverses, the panel's L and U
    work = N * (nblk * 2 * pb * pb + mb * wb + wb * wb)
    return LaunchPlan("large", len(grids), max(sm_panel, sm_upd),
                      tuple(grids), work)


def partial_lu_batch(F: torch.Tensor, thresh, *, wb: int,
                     nb: int = 32):
    """Partial LU of the leading `wb` columns of each front of F
    (N, mb, mb), in place.  `thresh` is a float or a one-element
    float64 tensor on F's device.  Returns (F, tiny, nzero), the counts
    as int64 scalar tensors on F's device.  `nb` is the plain version's
    block (the kernel blocks by `launch_plan`)."""
    if F.device.type == "cpu":
        return partial_lu_batch_plain(F, thresh, wb=wb, nb=nb)
    _cuda.require_cuda(F, tuple(LANES), "partial_lu_batch")
    N, mb, mb2 = F.shape
    if mb != mb2 or not F.is_contiguous():
        raise ValueError("partial_lu_batch: F must be a contiguous "
                         "(N, mb, mb) batch")
    if not isinstance(thresh, torch.Tensor):
        thresh = torch.full((1,), float(thresh), dtype=torch.float64,
                            device=F.device)
    elif (thresh.dtype != torch.float64 or thresh.numel() != 1
          or thresh.device != F.device):
        raise ValueError("partial_lu_batch: thresh must be a float or a "
                         "one-element float64 tensor on F's device")
    plan = launch_plan(N, mb, wb, F.dtype)
    lib = _cuda.library("panel_lu")
    tiny = torch.zeros(N, dtype=torch.int32, device=F.device)
    nzero = torch.zeros(N, dtype=torch.int32, device=F.device)
    # the bfloat16 lane's workspace is float32 (its working fronts and
    # the float32 lane's own)
    work = torch.empty(plan.work_elems, device=F.device,
                       dtype=(torch.float32 if F.dtype == torch.bfloat16
                              else F.dtype))
    lane = LANES[F.dtype]
    rc = getattr(lib, f"slu_panel_lu_{lane}")(F.data_ptr(), work.data_ptr() if plan.work_elems else None,
            N, mb, wb, _REGIME_CODE[plan.regime], thresh.data_ptr(),
            tiny.data_ptr(),
            nzero.data_ptr(), _cuda.stream_ptr(F))
    _cuda.check(lib, rc, "panel_lu")
    partial_lu_batch.launches += 1
    partial_lu_batch.lanes[lane] += 1
    return F, tiny.sum(dtype=torch.int64), nzero.sum(dtype=torch.int64)


partial_lu_batch.launches = 0
partial_lu_batch.lanes = collections.Counter()


def k1_flops(N: int, mb: int, wb: int) -> float:
    """Operations of the partial LU of N padded (mb, mb) fronts over
    `wb` columns: per eliminated column k, mb−k−1 divisions and the
    rank-1 update of the (mb−k−1)² trailing block."""
    s = sum((mb - k - 1) + 2.0 * (mb - k - 1) ** 2 for k in range(wb))
    return N * s


def k1_bytes(N: int, mb: int, itemsize: int) -> float:
    """Bytes K1 must move: every front element read once, written once."""
    return 2.0 * N * mb * mb * itemsize
