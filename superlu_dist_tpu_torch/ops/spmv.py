"""Device sparse matrix–vector/matrix products (pdgsmv analog).

The reference package's `ops/spmv.py`, in PyTorch: the residual
r = b − A·x of iterative refinement and the |A|·|x| of its backward
error, on the device.  Two layouts serve it:

  * COO: gather x at the column indices, multiply, and add into the
    rows (`index_add_`, whose atomic adds on the card run in an order
    that differs from run to run);
  * padded ELL (default): each row keeps a fixed-width band of column
    indices and values, and y = rowsum(vals · x[cols]) is a gather and
    a reduction with no scatter at all, so it is deterministic.  Pad
    slots carry a zero value.

`SLU_SPMV_LAYOUT` selects: `ell` forces, `coo` restores the scatter
formulation, `auto` (default) picks ELL unless the max-row-degree
padding would exceed `SLU_SPMV_ELL_WASTE`× the true nnz (a single
dense row would otherwise square the traffic).

Pad columns: the reference's ELL column plane carries the sentinel n
in pad slots and relies on XLA clamping the gather to row n−1.  A
torch gather with index n raises on the CPU and trips a device-side
assert on the card, so the device plane clamps the pads to n−1 once,
when it is built (`device_cols`): the same arithmetic, pad value 0
times x[n−1].  `ell_cols_from_src` itself returns the reference's
plane unchanged.

The double-word lanes of the reference (`ell_spmv_df64`,
`coo_spmv_df64`, `DeviceSpMV.matvec_df64`) are not ported yet:
`build(..., doubleword=True)` and `matvec_df64` raise (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flags
from ..device import resolve_device, torch_dtype

_DF64_TODO = ("the double-word (df64) SpMV lanes are not ported yet "
              "(ROADMAP queue 1 item 11, precision)")


def coo_spmv(rows, cols, vals, x, n: int):
    """y = A·x with A given as COO tensors; x is (n,) or (n, nrhs).
    `rows` may carry the sentinel n (that entry is dropped: the sum
    runs over n + 1 rows and the last is cut off); `cols` index x."""
    xg = x.index_select(0, cols)
    prod = xg * (vals[:, None] if x.ndim == 2 else vals)
    y = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=prod.dtype,
                    device=prod.device)
    y.index_add_(0, rows, prod)
    return y[:n]


def ell_from_csr(indptr, indices, nnz: int | None = None):
    """Host-side padded-ELL index build from CSR structure (the
    pdgsmv_init analog for the scatter-free layout).

    Returns (src, w): src (n_rows, w) with w = max row degree (at least
    1).  `src[i, k]` indexes the k-th stored entry of row i in the CSR
    value array; pad slots point at `nnz` (callers gather from a value
    array extended with one zero, so pads contribute exactly 0)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    if nnz is None:
        nnz = int(indptr[-1])
    counts = np.diff(indptr)
    n_rows = len(counts)
    w = max(int(counts.max(initial=0)), 1)
    src = np.full((n_rows, w), nnz, dtype=np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
    slot = np.arange(len(indices), dtype=np.int64) \
        - np.repeat(indptr[:-1], counts)
    src[rows, slot] = np.arange(len(indices), dtype=np.int64)
    return src, w


def ell_cols_from_src(src, indices, n_cols: int):
    """Column-index plane of the ELL build: pad slots carry the
    sentinel `n_cols` (the reference's plane; `device_cols` makes it
    safe to gather with)."""
    idx = np.concatenate([np.asarray(indices, dtype=np.int64),
                          np.asarray([n_cols], dtype=np.int64)])
    return idx[np.minimum(src, len(idx) - 1)]


def device_cols(ell_cols, n_cols: int, device) -> torch.Tensor:
    """The column plane as the device gathers it: the sentinel n_cols
    clamped to n_cols − 1 (the reference's gather clamps it there; the
    pad value 0 kills the lane)."""
    return torch.from_numpy(np.minimum(np.asarray(ell_cols, np.int64),
                                       max(n_cols - 1, 0))).to(device)


def ell_spmv(ell_cols, ell_vals, x):
    """y = A·x with A in padded-ELL form: per-row gather of the fixed
    band and a row reduction, no scatter.  `ell_cols` (n, w) column
    indices inside x (the device plane), `ell_vals` (n, w) with 0 at
    pads, x (n,) or (n, nrhs)."""
    xg = x[ell_cols]                       # (n, w[, nrhs])
    if x.ndim == 2:
        return torch.einsum("nw,nwr->nr", ell_vals, xg)
    return (ell_vals * xg).sum(dim=1)


def _ell_waste_limit() -> float:
    try:
        return flags.env_float("SLU_SPMV_ELL_WASTE", 4.0)
    except ValueError:
        return 4.0


def spmv_layout(nnz: int, n_rows: int, w: int) -> str:
    """Resolve the residual-SpMV layout: SLU_SPMV_LAYOUT = ell | coo |
    auto (default).  Auto takes ELL unless the fixed-band padding
    exceeds the waste limit — a near-dense row would turn the O(nnz)
    product into O(n·w)."""
    mode = flags.env_str("SLU_SPMV_LAYOUT", "auto").strip().lower()
    if mode in ("ell", "coo"):
        return mode
    return ("ell" if w * n_rows <= _ell_waste_limit() * max(nnz, 1)
            else "coo")


@dataclasses.dataclass
class DeviceSpMV:
    """Device SpMV operands (the pdgsmv_init product): the COO tensors
    always, and the padded-ELL planes when the layout resolves to ELL
    (spmv_layout).  The index tensors are the structure; `load` refills
    the value tensors in place from a new value set of the same
    pattern, so a captured program that reads them serves every value
    set."""
    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    abs_vals: torch.Tensor
    layout: str = "coo"
    ell_src: torch.Tensor | None = None   # (n, w) into vals + one zero
    ell_cols: torch.Tensor | None = None  # (n, w) device plane
    ell_vals: torch.Tensor | None = None
    ell_abs: torch.Tensor | None = None

    @classmethod
    def pattern(cls, indptr, indices, n: int, dtype, device,
                layout: str | None = None) -> "DeviceSpMV":
        """The operator of a CSR pattern (n × n, `indices` in CSR
        order) with zero values, in `dtype` on `device`; `load` fills
        them.  `layout` None resolves it (spmv_layout)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        nnz = len(indices)
        rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                         np.diff(indptr))
        src, w = ell_from_csr(indptr, indices, nnz=nnz)
        if layout is None:
            layout = spmv_layout(nnz, len(indptr) - 1, w)
        z = dict(dtype=torch_dtype(dtype), device=device)
        ell = {}
        if layout == "ell":
            ell = dict(
                ell_src=torch.from_numpy(src).to(device),
                ell_cols=device_cols(ell_cols_from_src(src, indices, n),
                                     n, device),
                ell_vals=torch.zeros(src.shape, **z),
                ell_abs=torch.zeros(src.shape, **z))
        return cls(n=n, rows=torch.from_numpy(rows).to(device),
                   cols=torch.from_numpy(indices).to(device),
                   vals=torch.zeros(nnz, **z),
                   abs_vals=torch.zeros(nnz, **z), layout=layout, **ell)

    @classmethod
    def build(cls, a, dtype=None, device=None,
              doubleword: bool = False) -> "DeviceSpMV":
        """The operator of the CSRMatrix `a` (values cast to `dtype`,
        default a's) on `device` (resolved as the entry points do)."""
        if doubleword:
            raise NotImplementedError(_DF64_TODO)
        vals = np.asarray(a.data)
        dt = np.dtype(dtype) if dtype is not None else vals.dtype
        op = cls.pattern(a.indptr, a.indices, a.n, dt,
                         resolve_device(device))
        op.load(vals)
        return op

    def load(self, vals) -> None:
        """Refill the value tensors in place from `vals` (the pattern's
        values in CSR order, numpy or a tensor, cast to the operator's
        dtype).  Starts no host sync when `vals` is on the device."""
        if not isinstance(vals, torch.Tensor):
            vals = torch.from_numpy(np.ascontiguousarray(vals))
        self.vals.copy_(vals)
        torch.abs(self.vals, out=self.abs_vals)
        if self.layout == "ell":
            ext = torch.cat([self.vals, self.vals.new_zeros(1)])
            torch.index_select(ext, 0, self.ell_src.view(-1),
                               out=self.ell_vals.view(-1))
            torch.abs(self.ell_vals, out=self.ell_abs)

    def matvec(self, x):
        if self.layout == "ell":
            return ell_spmv(self.ell_cols, self.ell_vals, x)
        return coo_spmv(self.rows, self.cols, self.vals, x, self.n)

    def absmatvec(self, x):
        if self.layout == "ell":
            return ell_spmv(self.ell_cols, self.ell_abs, x)
        return coo_spmv(self.rows, self.cols, self.abs_vals, x, self.n)

    def matvec_df64(self, x_hi, x_lo):
        raise NotImplementedError(_DF64_TODO)
