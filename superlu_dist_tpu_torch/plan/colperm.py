"""Fill-reducing column permutation.

Analog of get_perm_c_dist (SRC/get_perm_c.c:469,489) which dispatches
NATURAL / MMD (SRC/mmd.c) / METIS / COLAMD, and of the parallel
get_perm_c_parmetis.  This build orders the symmetrized pattern
B = pattern(A)+pattern(A)ᵀ (the MMD_AT_PLUS_A / METIS_AT_PLUS_A family;
A is assumed to have a nonzero diagonal after static-pivot row
permutation).  Dispatch order for the minimum-degree modes: native C++
AMD extension (csrc/) when built, else the pure-Python AMD fallback.
RCM (scipy) and NATURAL are always available.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..options import ColPerm
from ..sparse import CSRMatrix


def symmetrize_pattern(a: CSRMatrix) -> sp.csr_matrix:
    """Return the pattern of A + Aᵀ (values all 1.0, no diagonal
    guarantee — callers add the diagonal when needed)."""
    s = a.to_scipy()
    pat = sp.csr_matrix(
        (np.ones_like(s.data), s.indices, s.indptr), shape=s.shape)
    b = pat + pat.T
    b.sum_duplicates()
    b.sort_indices()
    return b


def _fill_reducing_order(b: sp.csr_matrix, mode: ColPerm,
                         nd_threads: int = 1) -> np.ndarray:
    from . import mindeg, nested
    n = b.shape[0]
    if mode in (ColPerm.METIS_AT_PLUS_A, ColPerm.PARMETIS):
        return nested.nd_order(b.indptr, b.indices, n,
                               threads=nd_threads)
    return mindeg.amd_order(b.indptr, b.indices, n)


def get_perm_c(a: CSRMatrix, mode: ColPerm,
               user_perm_c: np.ndarray | None = None,
               nd_threads: int = 1) -> np.ndarray:
    """Returns perm_c with perm_c[j] = new position of column j."""
    n = a.n
    if mode == ColPerm.NATURAL:
        return np.arange(n, dtype=np.int64)
    if mode == ColPerm.MY_PERMC:
        if user_perm_c is None:
            raise ValueError("ColPerm.MY_PERMC requires user_perm_c")
        return np.asarray(user_perm_c, dtype=np.int64)

    if mode in (ColPerm.MMD_ATA, ColPerm.COLAMD):
        # order the pattern of AᵀA (get_perm_c_dist's getata path;
        # COLAMD approximates the same object without forming it — at
        # our scales forming the boolean product is fine)
        s = a.to_scipy()
        pat = sp.csr_matrix(
            (np.ones_like(s.data), s.indices, s.indptr), shape=s.shape)
        b = (pat.T @ pat).tocsr()
        b.sum_duplicates()
        b.sort_indices()
    else:
        b = symmetrize_pattern(a)
    if mode == ColPerm.RCM:
        order = reverse_cuthill_mckee(b, symmetric_mode=True)
        perm_c = np.empty(n, dtype=np.int64)
        perm_c[np.asarray(order, dtype=np.int64)] = np.arange(n)
        return perm_c
    if mode in (ColPerm.MMD_AT_PLUS_A, ColPerm.MMD_ATA, ColPerm.AMD,
                ColPerm.COLAMD, ColPerm.METIS_AT_PLUS_A, ColPerm.PARMETIS):
        order = _fill_reducing_order(b, mode, nd_threads)
        perm_c = np.empty(n, dtype=np.int64)
        perm_c[order] = np.arange(n)
        return perm_c
    raise ValueError(f"unsupported ColPerm mode: {mode}")
