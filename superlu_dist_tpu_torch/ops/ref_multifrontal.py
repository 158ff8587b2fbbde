"""NumPy multifrontal LU on the host (unpadded): the host backend.

The sequential correctness oracle for the device path: one dense front
per supernode, processed in postorder, no bucketing/padding.  Mirrors
the dataflow of the reference's 3D tree factorization
(dsparseTreeFactor_ASYNC, SRC/dtreeFactorization.c:265) with the Schur
update expressed frontally instead of scattered into block storage
(SRC/dSchCompUdt-2Ddynamic.c).  It is what `backend="host"` runs
(models/gssvx.py), an explicit request for the CPU; no entry point
takes it on its own.  One Python iteration per column (a rank-1
update of the front), so it is for small systems and for checking.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.linalg as sla

from ..device import dtype_info
from ..plan.plan import FactorPlan


@dataclasses.dataclass
class HostLU:
    """Unpadded per-supernode factor panels (host memory)."""
    plan: FactorPlan
    # per supernode: L panel (m×w; unit-lower in top w), U panel (w×m)
    L: List[np.ndarray]
    U: List[np.ndarray]
    # precomputed inverses of the unit-lower / upper diagonal blocks:
    # the DiagInv=YES strategy (SRC/pdgssvx.c:1436-1447), as the device
    # factors hold them (the triangular solve becomes a product)
    Linv: List[np.ndarray]
    Uinv: List[np.ndarray]
    tiny_pivots: int


def factorize_host(plan: FactorPlan, scaled_vals: np.ndarray,
                   dtype=np.float64) -> HostLU:
    fp = plan.frontal
    part = fp.sym.part
    ns = fp.nsuper
    xsup = part.xsup
    # the dtype's own eps (np.finfo: the square root below rounds as
    # the reference's does); numpy has no bfloat16, which gssvx refuses
    # on this backend
    eps = np.finfo(dtype_info(dtype).numpy).eps
    thresh = np.sqrt(eps) * plan.anorm
    replace = bool(plan.options.replace_tiny_pivot)

    vals = scaled_vals.astype(dtype)
    updates: List[np.ndarray | None] = [None] * ns
    L: List[np.ndarray] = [None] * ns  # type: ignore
    U: List[np.ndarray] = [None] * ns  # type: ignore
    Linv: List[np.ndarray] = [None] * ns  # type: ignore
    Uinv: List[np.ndarray] = [None] * ns  # type: ignore
    tiny = 0

    for s in range(ns):
        w = int(fp.w[s]); m = int(fp.m[s])
        F = np.zeros((m, m), dtype=dtype)
        # assemble A entries
        np.add.at(F, (fp.a_lr[s], fp.a_lc[s]), vals[fp.a_src[s]])
        # extend-add child updates
        for c in fp.sym.children[s]:
            upd = updates[c]
            if upd is not None and upd.size:
                pos = fp.ea_map[c]
                F[np.ix_(pos, pos)] += upd
                updates[c] = None
        # partial LU of leading w×w, right-looking, tiny-pivot guard
        for k in range(w):
            piv = F[k, k]
            if replace and np.abs(piv) < thresh:
                # preserve the pivot's phase (sign·thresh, as K1
                # replaces it, so the host stays an exact oracle)
                apiv = np.abs(piv)
                piv = (piv / apiv) * thresh if apiv > 0 else \
                    np.asarray(thresh, dtype=dtype)
                F[k, k] = piv
                tiny += 1
            elif piv == 0:
                raise ZeroDivisionError(
                    f"exact zero pivot at column {xsup[s] + k}")
            F[k + 1:, k] /= piv
            F[k + 1:, k + 1:] -= np.outer(F[k + 1:, k], F[k, k + 1:])
        Ls = np.tril(F[:, :w], -1)
        Ls[np.arange(w), np.arange(w)] = 1.0
        Us = np.triu(F[:w, :])
        L[s] = Ls
        U[s] = Us
        # diag-block inverses for the GEMM-form trisolve
        eye = np.eye(w, dtype=dtype)
        Linv[s] = sla.solve_triangular(Ls[:w], eye, lower=True,
                                       unit_diagonal=True)
        Uinv[s] = sla.solve_triangular(Us[:, :w], eye, lower=False)
        updates[s] = F[w:, w:].copy() if m > w else np.zeros((0, 0), dtype)

    return HostLU(plan=plan, L=L, U=U, Linv=Linv, Uinv=Uinv,
                  tiny_pivots=tiny)


def solve_host(lu: HostLU, b: np.ndarray) -> np.ndarray:
    """Solve using the factored panels; b is (n,) or (n, nrhs) in the
    FACTOR ordering and scaling (caller handles perms/scales)."""
    plan = lu.plan
    fp = plan.frontal
    part = fp.sym.part
    xsup = part.xsup
    ns = fp.nsuper
    # promote rather than copy: a real rhs against a complex factor
    # must become complex (mirrors the device backend's promote_types)
    xdt = np.promote_types(lu.L[0].dtype if ns else b.dtype, b.dtype)
    x = b.astype(xdt)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]

    # forward: leaves → root over the supernodal etree (postorder)
    for s in range(ns):
        first, last = int(xsup[s]), int(xsup[s + 1])
        w = int(fp.w[s])
        y1 = lu.Linv[s] @ x[first:last]
        x[first:last] = y1
        if fp.r[s]:
            x[fp.sym.struct[s]] -= lu.L[s][w:] @ y1
    # backward: root → leaves
    for s in range(ns - 1, -1, -1):
        first, last = int(xsup[s]), int(xsup[s + 1])
        w = int(fp.w[s])
        rhs = x[first:last]
        if fp.r[s]:
            rhs = rhs - lu.U[s][:, w:] @ x[fp.sym.struct[s]]
        x[first:last] = lu.Uinv[s] @ rhs

    return x[:, 0] if squeeze else x


def solve_host_trans(lu: HostLU, b: np.ndarray) -> np.ndarray:
    """Solve Mᵀ·x = b where M = L·U is the factored matrix (factor
    ordering).  Mᵀ = Uᵀ·Lᵀ: forward sweep on the lower-triangular Uᵀ,
    backward on the unit-upper Lᵀ — the pdgstrs TRANS contract
    (SRC/pdgstrs.c trans branch) expressed panel-wise."""
    plan = lu.plan
    fp = plan.frontal
    part = fp.sym.part
    xsup = part.xsup
    ns = fp.nsuper
    xdt = np.promote_types(lu.L[0].dtype if ns else b.dtype, b.dtype)
    x = b.astype(xdt)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]

    # forward with Uᵀ: diag block (U_ss)ᵀ, sub-block (U panel cols)ᵀ
    for s in range(ns):
        first, last = int(xsup[s]), int(xsup[s + 1])
        w = int(fp.w[s])
        y1 = lu.Uinv[s].T @ x[first:last]
        x[first:last] = y1
        if fp.r[s]:
            x[fp.sym.struct[s]] -= lu.U[s][:, w:].T @ y1
    # backward with Lᵀ (unit upper)
    for s in range(ns - 1, -1, -1):
        first, last = int(xsup[s]), int(xsup[s + 1])
        w = int(fp.w[s])
        rhs = x[first:last]
        if fp.r[s]:
            rhs = rhs - lu.L[s][w:].T @ x[fp.sym.struct[s]]
        x[first:last] = lu.Linv[s].T @ rhs

    return x[:, 0] if squeeze else x
