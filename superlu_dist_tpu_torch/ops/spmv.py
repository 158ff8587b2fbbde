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

The double-word lanes (`ell_spmv_df64`, `coo_spmv_df64`,
`DeviceSpMV.matvec_df64`): A's values and x as exact (hi, lo) fp32
pairs (precision/doubleword.py).  The ELL lane is kernel K4 on the card
(ops/df64_spmv.py) and its plain version on the CPU; the COO lane is
plain PyTorch (`index_add_`, a scatter, as in the reference), and its
row sums stay fp32-class, so a doubleword operator takes ELL whatever
the padding unless SLU_SPMV_LAYOUT=coo is explicit
(`doubleword_layout`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flags
from ..device import resolve_device, torch_dtype
from ..precision.doubleword import (df64_coo_spmv, split_f64,
                                    split_f64_tensor)
from .df64_spmv import df64_ell_spmv


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


def ell_spmv_df64(ell_cols, vals_hi, vals_lo, x_hi, x_lo):
    """Double-word lane of the ELL product: A and x as exact (hi, lo)
    fp32 pairs, the band reduction compensated (kernel K4 on the card,
    its plain version on the CPU).  Returns the (hi, lo) pair."""
    return df64_ell_spmv(ell_cols, vals_hi, vals_lo, x_hi, x_lo)


def coo_spmv_df64(rows, cols, vals_hi, vals_lo, x_hi, x_lo, n: int):
    """Double-word COO lane: exact df64 term products, fp32-class row
    sums (precision/doubleword.df64_coo_spmv)."""
    return df64_coo_spmv(rows, cols, vals_hi, vals_lo, x_hi, x_lo, n)


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


def doubleword_layout(layout: str) -> str:
    """The layout of a doubleword residual: precision outranks the
    pad-waste heuristic, so ELL unless SLU_SPMV_LAYOUT=coo is explicit
    (the COO lane's scatter sum stays fp32-class)."""
    if layout != "ell" and flags.env_str(
            "SLU_SPMV_LAYOUT", "auto").strip().lower() != "coo":
        return "ell"
    return layout


@dataclasses.dataclass
class DeviceSpMV:
    """Device SpMV operands (the pdgsmv_init product): the COO tensors
    always, and the padded-ELL planes when the layout resolves to ELL
    (spmv_layout).  Values may be real or complex; their moduli (|A|,
    the berr denominator's operator) are real.  The index tensors are the structure; `load` refills
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
    # doubleword operators (build(..., doubleword=True)): the lo planes
    # of the exact fp32 split of the float64 values, whose hi planes are
    # `vals` / `ell_vals`
    vals_lo: torch.Tensor | None = None
    ell_vals_lo: torch.Tensor | None = None

    @classmethod
    def pattern(cls, indptr, indices, n: int, dtype, device,
                layout: str | None = None,
                doubleword: bool = False) -> "DeviceSpMV":
        """The operator of a CSR pattern (n × n, `indices` in CSR
        order) with zero values, in `dtype` on `device`; `load` fills
        them.  `layout` None resolves it (spmv_layout; a doubleword
        operator resolves through doubleword_layout).  `doubleword`:
        float32 (hi, lo) value planes, whatever `dtype` says."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        nnz = len(indices)
        rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                         np.diff(indptr))
        src, w = ell_from_csr(indptr, indices, nnz=nnz)
        if layout is None:
            layout = spmv_layout(nnz, len(indptr) - 1, w)
            if doubleword:
                layout = doubleword_layout(layout)
        tdt = torch.float32 if doubleword else torch_dtype(dtype)
        z = dict(dtype=tdt, device=device)
        # |A| is real for a complex operator too (the berr denominator)
        za = dict(dtype=tdt.to_real(), device=device)
        ell = {}
        if layout == "ell":
            ell = dict(
                ell_src=torch.from_numpy(src).to(device),
                ell_cols=device_cols(ell_cols_from_src(src, indices, n),
                                     n, device),
                ell_vals=torch.zeros(src.shape, **z),
                ell_abs=torch.zeros(src.shape, **za))
            if doubleword:
                ell["ell_vals_lo"] = torch.zeros(src.shape, **z)
        return cls(n=n, rows=torch.from_numpy(rows).to(device),
                   cols=torch.from_numpy(indices).to(device),
                   vals=torch.zeros(nnz, **z),
                   abs_vals=torch.zeros(nnz, **za), layout=layout,
                   vals_lo=(torch.zeros(nnz, **z) if doubleword else None),
                   **ell)

    @classmethod
    def build(cls, a, dtype=None, device=None,
              doubleword: bool = False) -> "DeviceSpMV":
        """The operator of the CSRMatrix `a` (values cast to `dtype`,
        default a's) on `device` (resolved as the entry points do).
        `doubleword`: the exact fp32 (hi, lo) split of a's float64
        values (split on the host), for matvec_df64; the hi plane is
        the operator's fp32 value set."""
        vals = np.asarray(a.data)
        dt = np.dtype(dtype) if dtype is not None else vals.dtype
        op = cls.pattern(a.indptr, a.indices, a.n, dt,
                         resolve_device(device), doubleword=doubleword)
        if doubleword:
            op.load(*split_f64(vals))
        else:
            op.load(vals)
        return op

    def load(self, vals, vals_lo=None) -> None:
        """Refill the value tensors in place from `vals` (the pattern's
        values in CSR order, numpy or a tensor, cast to the operator's
        dtype).  A doubleword operator takes the (hi, lo) planes as
        `vals` and `vals_lo`, or splits `vals` (float64) on its
        device.  Starts no host sync when `vals` is on the device."""
        def dev(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            return v.to(self.vals.device)
        if self.vals_lo is not None:
            if vals_lo is None:
                vals, vals_lo = split_f64_tensor(dev(vals))
            self.vals_lo.copy_(dev(vals_lo))
        elif vals_lo is not None:
            raise ValueError("DeviceSpMV was not built with "
                             "doubleword=True")
        self.vals.copy_(dev(vals))
        torch.abs(self.vals, out=self.abs_vals)
        if self.layout == "ell":
            self._ell_plane(self.vals, self.ell_vals)
            torch.abs(self.ell_vals, out=self.ell_abs)
            if self.vals_lo is not None:
                self._ell_plane(self.vals_lo, self.ell_vals_lo)

    def _ell_plane(self, v: torch.Tensor, out: torch.Tensor) -> None:
        """Values in CSR order -> the padded ELL plane `out` (pad slots
        read the appended zero)."""
        ext = torch.cat([v, v.new_zeros(1)])
        torch.index_select(ext, 0, self.ell_src.view(-1), out=out.view(-1))

    def matvec(self, x):
        if self.layout == "ell":
            return ell_spmv(self.ell_cols, self.ell_vals, x)
        return coo_spmv(self.rows, self.cols, self.vals, x, self.n)

    def absmatvec(self, x):
        if self.layout == "ell":
            return ell_spmv(self.ell_cols, self.ell_abs, x)
        return coo_spmv(self.rows, self.cols, self.abs_vals, x, self.n)

    def matvec_df64(self, x_hi, x_lo):
        """y = A·x in double-word precision (build with
        doubleword=True first); returns the (hi, lo) pair."""
        if self.vals_lo is None:
            raise ValueError("DeviceSpMV was not built with "
                             "doubleword=True")
        if self.layout == "ell":
            return ell_spmv_df64(self.ell_cols, self.ell_vals,
                                 self.ell_vals_lo, x_hi, x_lo)
        return coo_spmv_df64(self.rows, self.cols, self.vals,
                             self.vals_lo, x_hi, x_lo, self.n)
