"""Kernel K2: the extend-add scatter of one element bucket
(csrc/ea_scatter.cu).

Replaces the reference's Pallas kernel
superlu_dist_tpu/ops/pallas_scatter.py (`scatter_add_delta`), which
took gathered child blocks and returned a delta the caller added to
the fronts (ops/batched._ea_add).  Here the gather of the child blocks
out of the update slab is folded into the kernel and the adds go into
the front batch in place.

On a CUDA tensor `ea_scatter_add` launches the kernel; on a CPU tensor
it runs the plain version (`ea_scatter_add_plain`: a masked gather plus
`index_add_`), never the other way round.  `ea_scatter_add.launches`
counts kernel launches (one per bucket), and `ea_scatter_add.lanes`
the same launches per lane (bf16, f32, f64, c64, c128; the bf16 lane
adds in float32 and rounds once per store).

Narrow buckets (children at most NARROW wide) carry per-destination
lists, derived on the host once per schedule (`destination_lists`):
the kernel gives each destination one thread, which adds the child
values that land there in record order.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _cuda

# widest child bucket whose lanes go to per-destination lists
NARROW = 32

# the kernel's lane (the suffix of its launcher's name) per element type
LANES = {torch.bfloat16: "bf16", torch.float32: "f32",
         torch.float64: "f64", torch.complex64: "c64",
         torch.complex128: "c128"}


@dataclasses.dataclass
class EaBucket:
    """One element bucket's real records on the device (K-padding
    records dropped on the host): child slab offset `so`, slab row
    stride `st`, front base `db` (front · mb²), destination positions
    `pr` (nrec, rc_b) with sentinel mb, and the front-sorted record
    ranges: records seg[f]..seg[f+1] belong to front fronts[f].
    Narrow buckets also carry `destination_lists` (else None)."""
    rc_b: int
    so: torch.Tensor
    st: torch.Tensor
    db: torch.Tensor
    pr: torch.Tensor
    fronts: torch.Tensor
    seg: torch.Tensor
    head_dst: Optional[torch.Tensor] = None
    head_src: Optional[torch.Tensor] = None
    head_src2: Optional[torch.Tensor] = None
    xptr: Optional[torch.Tensor] = None
    xsrc: Optional[torch.Tensor] = None


def destination_lists(so, st, db, pr, mb: int):
    """The bucket's live lanes grouped by destination, host numpy int64:
    (head_dst, head_src, head_src2, xptr, xsrc).  Destination h is the
    flat front element head_dst[h]; the child values that land there,
    in record order, are slab elements head_src[h], then head_src2[h]
    (-1: none), then xsrc[xptr[h]:xptr[h+1]].  Sentinel lanes are
    dropped before any slab index is kept."""
    rc_b = pr.shape[1]
    i = np.arange(rc_b)
    src = (so[:, None, None] + i[None, :, None] * st[:, None, None]
           + i[None, None, :])
    live = (pr[:, :, None] < mb) & (pr[:, None, :] < mb)
    dst = db[:, None, None] + pr[:, :, None] * mb + pr[:, None, :]
    dst, src = dst[live], src[live]               # record-major
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    h = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]]) if len(dst) \
        else np.zeros(0, np.int64)
    mult = np.diff(np.r_[h, len(dst)])
    src2 = np.where(mult > 1, src[np.minimum(h + 1, len(src) - 1)], -1)
    rest = np.ones(len(dst), bool)                # third value onwards
    rest[h] = False
    rest[h[mult > 1] + 1] = False
    xptr = np.r_[0, np.cumsum(np.maximum(mult - 2, 0))]
    return dst[h], src[h], src2, xptr.astype(np.int64), src[rest]


def flat_indices(F: torch.Tensor, b: EaBucket):
    """(dst, src) flat indices of the bucket's live lanes: front
    elements of F and slab elements.  A lane is live when both its row
    and column positions are below mb; padding lanes are masked before
    any slab index is formed into a read."""
    mb = F.shape[-1]
    i = torch.arange(b.rc_b, device=F.device)
    src = (b.so[:, None, None] + i[None, :, None] * b.st[:, None, None]
           + i[None, None, :])
    pi = b.pr[:, :, None]
    pj = b.pr[:, None, :]
    live = (pi < mb) & (pj < mb)
    dst = b.db[:, None, None] + pi * mb + pj
    return dst[live], src[live]


def ea_scatter_add_plain(F: torch.Tensor, upd_buf: torch.Tensor,
                         b: EaBucket) -> None:
    """The element extend-add lane in PyTorch: masked gather from the
    slab, `index_add_` into the fronts (in place).  bfloat16 adds in
    float32 and rounds once into F."""
    dst, src = flat_indices(F, b)
    if F.dtype == torch.bfloat16:
        Fw = F.view(-1).float()
        Fw.index_add_(0, dst, upd_buf[src].float())
        F.view(-1).copy_(Fw)
        return
    F.view(-1).index_add_(0, dst, upd_buf[src])


def ea_scatter_add(F: torch.Tensor, upd_buf: torch.Tensor,
                   b: EaBucket) -> None:
    """Add the bucket's child update blocks into the front batch F
    (n_pad, mb, mb), in place."""
    if F.device.type == "cpu":
        ea_scatter_add_plain(F, upd_buf, b)
        return
    _cuda.require_cuda(F, tuple(LANES), "ea_scatter")
    if upd_buf.dtype != F.dtype or upd_buf.device != F.device:
        raise TypeError("ea_scatter: slab and fronts must share dtype "
                        "and device")
    if not (F.is_contiguous() and upd_buf.is_contiguous()
            and b.pr.is_contiguous()):
        raise ValueError("ea_scatter: contiguous operands required")
    mb = F.shape[-1]
    lib = _cuda.library("ea_scatter")
    lane = LANES[F.dtype]
    fn = getattr(lib, f"slu_ea_scatter_{lane}")
    lists = (b.head_dst, b.head_src, b.head_src2, b.xptr, b.xsrc)
    if b.head_dst is None:
        lists, nheads = (None,) * 5, 0            # the banded variant
    else:
        nheads = b.head_dst.numel()
    rc = fn(F.data_ptr(), upd_buf.data_ptr(), b.so.data_ptr(),
            b.st.data_ptr(), b.pr.data_ptr(), b.fronts.data_ptr(),
            b.seg.data_ptr(), b.fronts.numel(), b.rc_b, mb,
            *[None if t is None else t.data_ptr() for t in lists], nheads,
            _cuda.stream_ptr(F))
    _cuda.check(lib, rc, "ea_scatter")
    ea_scatter_add.launches += 1
    ea_scatter_add.lanes[lane] += 1


ea_scatter_add.launches = 0
ea_scatter_add.lanes = collections.Counter()


def bound_work(b: EaBucket, mb: int, itemsize: int) -> tuple:
    """(live lanes, bytes) the extend-add of bucket `b` into (·, mb, mb)
    fronts must move at least: each live lane's slab value read and its
    front element read and written, the records' int64 row maps and
    offsets, and the fronts' segment table.  The adds are the lanes."""
    live = int(((b.pr < mb).sum(1) ** 2).sum())
    nrec = int(b.so.numel())
    nbytes = (3.0 * live * itemsize + nrec * b.rc_b * 8 + nrec * 16
              + b.fronts.numel() * 16)
    return live, nbytes
