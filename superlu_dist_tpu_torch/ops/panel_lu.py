"""Kernel K1: the batched front partial LU (csrc/panel_lu.cu).

Replaces the reference's Pallas kernel
superlu_dist_tpu/ops/pallas_lu.py (`partial_lu_batch_pallas` →
`_pallas_lu_call`).  On a CUDA tensor `partial_lu_batch` launches the
kernel; on a CPU tensor it runs the plain version,
ops/dense_lu.partial_lu_batch, which computes the same function.  It
never falls back from one to the other: a CUDA tensor the kernel does
not take raises.

`partial_lu_batch.launches` counts the calls that launched the kernel
(one per group; each call runs three kernels per nb-wide block step).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .dense_lu import partial_lu_batch as partial_lu_batch_plain


def partial_lu_batch(F: torch.Tensor, thresh: float, *, wb: int,
                     nb: int = 32):
    """Partial LU of the leading `wb` columns of each front of F
    (N, mb, mb), in place.  Returns (F, tiny, nzero), the counts as
    int64 scalar tensors on F's device."""
    if F.device.type == "cpu":
        return partial_lu_batch_plain(F, thresh, wb=wb, nb=nb)
    _cuda.require_cuda(F, (torch.float32, torch.float64),
                       "partial_lu_batch")
    N, mb, mb2 = F.shape
    nb = min(nb, wb)
    if mb != mb2 or not F.is_contiguous():
        raise ValueError("partial_lu_batch: F must be a contiguous "
                         "(N, mb, mb) batch")
    if wb % nb or nb > 32 or wb > mb:
        raise ValueError(f"partial_lu_batch: unsupported wb={wb}, "
                         f"nb={nb}, mb={mb}")
    lib = _cuda.library("panel_lu")
    tiny = torch.zeros(N, dtype=torch.int32, device=F.device)
    nzero = torch.zeros(N, dtype=torch.int32, device=F.device)
    fn = (lib.slu_panel_lu_f64 if F.dtype == torch.float64
          else lib.slu_panel_lu_f32)
    rc = fn(F.data_ptr(), N, mb, wb, nb, ctypes.c_double(float(thresh)),
            tiny.data_ptr(), nzero.data_ptr(), _cuda.stream_ptr(F))
    _cuda.check(lib, rc, "panel_lu")
    partial_lu_batch.launches += 1
    return F, tiny.sum(dtype=torch.int64), nzero.sum(dtype=torch.int64)


partial_lu_batch.launches = 0
