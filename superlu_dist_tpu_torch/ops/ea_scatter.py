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
counts kernel launches (one per bucket).
"""

from __future__ import annotations

import dataclasses

import torch

from . import _cuda


@dataclasses.dataclass
class EaBucket:
    """One element bucket's real records on the device (K-padding
    records dropped on the host): child slab offset `so`, slab row
    stride `st`, front base `db` (front · mb²), destination positions
    `pr` (nrec, rc_b) with sentinel mb, and the front-sorted record
    ranges: records seg[f]..seg[f+1] belong to front fronts[f]."""
    rc_b: int
    so: torch.Tensor
    st: torch.Tensor
    db: torch.Tensor
    pr: torch.Tensor
    fronts: torch.Tensor
    seg: torch.Tensor


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
    slab, `index_add_` into the fronts (in place)."""
    dst, src = flat_indices(F, b)
    F.view(-1).index_add_(0, dst, upd_buf[src])


def ea_scatter_add(F: torch.Tensor, upd_buf: torch.Tensor,
                   b: EaBucket) -> None:
    """Add the bucket's child update blocks into the front batch F
    (n_pad, mb, mb), in place."""
    if F.device.type == "cpu":
        ea_scatter_add_plain(F, upd_buf, b)
        return
    _cuda.require_cuda(F, (torch.float32, torch.float64), "ea_scatter")
    if upd_buf.dtype != F.dtype or upd_buf.device != F.device:
        raise TypeError("ea_scatter: slab and fronts must share dtype "
                        "and device")
    if not (F.is_contiguous() and upd_buf.is_contiguous()
            and b.pr.is_contiguous()):
        raise ValueError("ea_scatter: contiguous operands required")
    mb = F.shape[-1]
    lib = _cuda.library("ea_scatter")
    fn = (lib.slu_ea_scatter_f64 if F.dtype == torch.float64
          else lib.slu_ea_scatter_f32)
    rc = fn(F.data_ptr(), upd_buf.data_ptr(), b.so.data_ptr(),
            b.st.data_ptr(), b.pr.data_ptr(), b.fronts.data_ptr(),
            b.seg.data_ptr(), b.fronts.numel(), b.rc_b, mb,
            _cuda.stream_ptr(F))
    _cuda.check(lib, rc, "ea_scatter")
    ea_scatter_add.launches += 1


ea_scatter_add.launches = 0
