"""Kernel K4: the double-word ELL residual product (csrc/df64_spmv.cu).

y = A·x with A's values and x both exact (hi, lo) fp32 pairs: a per-row
gather of the ELL band, df_mul per term and a df_add scan across the
band in slot order, the result a (hi, lo) pair.  It replaces no TPU
kernel (the reference computes this lane in plain jnp,
superlu_dist_tpu/precision/doubleword.py `df64_ell_spmv`); it runs on
every step of the fused solver's doubleword refinement
(ops/batched.py), through ops/spmv.ell_spmv_df64.

On CUDA tensors `df64_ell_spmv` launches the kernel; on CPU tensors it
runs the plain version, precision/doubleword.df64_ell_spmv, which
performs the same operations in the same order (the kernel is held
bitwise to it on the card).  It never falls back from one to the
other: a CUDA operand the kernel does not take raises, and so does a
kernel library that fails to build.  `df64_ell_spmv.launches` counts
kernel launches (and `lanes`, its one lane "df64", the same, so that a
captured graph carries them forward as it does K1–K3's).
"""

from __future__ import annotations

import collections

import torch

from . import _cuda
from ..precision.doubleword import df64_ell_spmv as df64_ell_spmv_plain

# f32 operations per ELL slot and right-hand side: df_mul (two_prod 17,
# the cross terms 4, quick_two_sum 3) and df_add (20)
FLOPS_PER_TERM = 44


def df64_ell_spmv(ell_cols, vals_hi, vals_lo, x_hi, x_lo):
    """`ell_cols` (n, w) int64 column indices in [0, n) (pad slots any
    valid index, with zero values), `vals_hi/vals_lo` (n, w) float32,
    `x_hi/x_lo` (n,) or (n, nrhs) float32.  Returns (y_hi, y_lo) of x's
    shape."""
    if x_hi.device.type == "cpu":
        return df64_ell_spmv_plain(ell_cols, vals_hi, vals_lo, x_hi, x_lo)
    planes = (vals_hi, vals_lo, x_hi, x_lo)
    for t, what in zip(planes, ("vals_hi", "vals_lo", "x_hi", "x_lo")):
        _cuda.require_cuda(t, (torch.float32,), f"df64_ell_spmv {what}")
    _cuda.require_cuda(ell_cols, (torch.int64,), "df64_ell_spmv cols")
    n, w = ell_cols.shape
    R = x_hi.shape[1] if x_hi.dim() == 2 else 1
    if (vals_hi.shape != (n, w) or vals_lo.shape != (n, w)
            or x_lo.shape != x_hi.shape or x_hi.shape[0] != n
            or x_hi.dim() not in (1, 2)):
        raise ValueError("df64_ell_spmv: shapes do not match: cols "
                         f"{tuple(ell_cols.shape)}, x {tuple(x_hi.shape)}")
    if not all(t.is_contiguous() for t in planes + (ell_cols,)):
        raise ValueError("df64_ell_spmv: contiguous operands required")
    yh = torch.empty_like(x_hi)
    yl = torch.empty_like(x_lo)
    lib = _cuda.library("df64_spmv")
    rc = lib.slu_df64_ell_spmv(
        ell_cols.data_ptr(), vals_hi.data_ptr(), vals_lo.data_ptr(),
        x_hi.data_ptr(), x_lo.data_ptr(), yh.data_ptr(), yl.data_ptr(),
        n, w, R, _cuda.stream_ptr(x_hi))
    _cuda.check(lib, rc, "df64_spmv")
    df64_ell_spmv.launches += 1
    df64_ell_spmv.lanes["df64"] += 1
    return yh, yl


df64_ell_spmv.launches = 0
df64_ell_spmv.lanes = collections.Counter()   # one lane, "df64"


def bound_work(n: int, w: int, R: int, index_bytes: int = 8) -> tuple:
    """(flops, bytes) of one product: each slot's column index and two
    value planes read once, x's two planes read once and y's two
    written once (fp32); FLOPS_PER_TERM per slot and column."""
    flops = float(FLOPS_PER_TERM) * n * w * R
    nbytes = n * w * (index_bytes + 8.0) + 2 * (2 * 4.0 * n * R)
    return flops, nbytes
