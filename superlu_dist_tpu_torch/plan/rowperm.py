"""Static-pivoting row permutation: put large entries on the diagonal.

Analog of dldperm_dist → mc64ad_dist (SRC/dldperm_dist.c:96,
SRC/mc64ad_dist.c:121; dispatched at SRC/pdgssvx.c:815) and the HWPM
path (SRC/d_c2cpp_GetHWPM.cpp).  The numerical-stability contract of
GESP: after this permutation (plus equilibration) the diagonal is as
large as possible, so the numeric factorization needs no pivoting —
which is what makes the whole solver a fixed, precomputed schedule.

MC64 job=5 (maximize the product of diagonal magnitudes) is realized
as a min-weight full bipartite matching on C[i,j] =
log(max_i|a_ij| / |a_ij|) — the standard Duff–Koster transform.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import min_weight_full_bipartite_matching

from ..options import RowPerm
from ..sparse import CSRMatrix


def _native_matching(a: CSRMatrix, run):
    """Shared native-dispatch shell for the matching family: CSC
    conversion + int64 casts + singular-error re-wrap.  `run(native,
    n, indptr, indices, absval)` returns perm_r or None to decline
    (then the scipy exact matching runs)."""
    from ..utils.native import native_or_none
    native = native_or_none()
    if native is not None and a.m == a.n:
        acsc = a.to_scipy().tocsc()
        acsc.sort_indices()
        try:
            perm_r = run(native, a.n, acsc.indptr.astype(np.int64),
                         acsc.indices.astype(np.int64),
                         np.abs(acsc.data))
            if perm_r is not None:
                return perm_r
        except ValueError as e:
            raise ValueError(f"structurally singular matrix: {e}") from e
    return large_diag_perm_py(a)


def large_diag_perm(a: CSRMatrix) -> np.ndarray:
    """Return perm_r with perm_r[i] = new position of row i, such that
    (Pr·A) has a structurally perfect, product-maximal diagonal.
    Dispatches to the native C++ MC64 (csrc/slu_host.cpp slu_mc64, the
    shortest-augmenting-path Duff–Koster algorithm); scipy fallback."""
    return _native_matching(
        a, lambda nat, n, ip, ix, av: nat.mc64(n, ip, ix, av)[0])


def large_diag_perm_py(a: CSRMatrix) -> np.ndarray:
    """scipy-based fallback / test oracle for large_diag_perm."""
    rows, cols, vals = a.to_coo()
    absv = np.abs(vals)
    if np.any(absv == 0.0):
        keep = absv > 0.0
        rows, cols, absv = rows[keep], cols[keep], absv[keep]
    # column-wise max (matching runs on the bipartite rows×cols graph;
    # normalizing per column keeps weights ≥ 0 as MC64 does)
    cmax = np.zeros(a.n)
    np.maximum.at(cmax, cols, absv)
    if np.any(cmax == 0.0):
        raise ValueError("structurally singular: empty column")
    w = np.log(cmax[cols]) - np.log(absv)
    # biadjacency with strictly positive stored weights (shift by 1)
    g = sp.csr_matrix((w + 1.0, (rows, cols)), shape=(a.m, a.n))
    try:
        row_ind, col_ind = min_weight_full_bipartite_matching(g)
    except ValueError as e:
        raise ValueError(f"structurally singular matrix: {e}") from e
    perm_r = np.empty(a.m, dtype=np.int64)
    # row row_ind[k] is matched to column col_ind[k]: send it to
    # position col_ind[k] so the matched entry lands on the diagonal
    perm_r[row_ind] = col_ind
    return perm_r


def large_diag_perm_hwpm(a: CSRMatrix) -> np.ndarray:
    """Approximate heavy-weight perfect matching — the parallel
    LargeDiag_HWPM slot (SRC/d_c2cpp_GetHWPM.cpp →
    dHWPM_CombBLAS.hpp:60).  Trades exactness of the diagonal product
    for near-linear parallel time: a threaded locally-dominant greedy
    matching (≥1/2-approximation) completed to a perfect matching by
    augmenting paths (csrc/slu_host.cpp slu_hwpm).  The GESP contract
    (structurally full diagonal, large entries favored) holds; residual
    quality after equilibration + iterative refinement matches MC64 on
    the reference test matrices (tests/test_rowperm_hwpm.py).  Falls
    back to the exact matching when the native library is unavailable
    or n exceeds the proposal-key packing limit (quality superset,
    same contract)."""
    def run(nat, n, ip, ix, av):
        try:
            return nat.hwpm(n, ip, ix, av)
        except OverflowError:
            return None  # n ≥ 2^32: decline to the exact matching
    return _native_matching(a, run)


def get_perm_r(a: CSRMatrix, mode: RowPerm,
               user_perm_r: np.ndarray | None = None) -> np.ndarray:
    if mode == RowPerm.NOROWPERM:
        return np.arange(a.m, dtype=np.int64)
    if mode == RowPerm.MY_PERMR:
        if user_perm_r is None:
            raise ValueError("RowPerm.MY_PERMR requires user_perm_r")
        return np.asarray(user_perm_r, dtype=np.int64)
    if mode == RowPerm.LARGE_DIAG_HWPM:
        # the parallel approximate-matching escape hatch for the
        # serial-MC64 scalability cliff (SURVEY.md §7 hard part #5)
        return large_diag_perm_hwpm(a)
    return large_diag_perm(a)
