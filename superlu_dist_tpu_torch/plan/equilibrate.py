"""Equilibration: row/column scaling of A.

Analog of pdgsequ/pdlaqgs (SRC/pdgsequ.c, SRC/pdlaqgs.c, called from
SRC/pdgssvx.c:718,736): r_i = 1/max_j|a_ij|, c_j = 1/max_i|r_i·a_ij|,
applied when the scaling spread warrants it.  The reference's
distributed allreduce of row/col norms becomes plain host reductions
here (the scalings are part of the once-per-pattern plan)."""

from __future__ import annotations

import numpy as np

from ..sparse import CSRMatrix


def gsequ(a: CSRMatrix):
    """Compute row and column scale factors.  Returns (r, c, rowcnd,
    colcnd, amax) following the dgsequ_dist contract."""
    rows, cols, vals = a.to_coo()
    absv = np.abs(vals)
    amax = absv.max() if len(absv) else 0.0

    rmax = np.zeros(a.m)
    np.maximum.at(rmax, rows, absv)
    if np.any(rmax == 0.0):
        raise ValueError("matrix has an empty row; singular")
    r = 1.0 / rmax

    cmax = np.zeros(a.n)
    np.maximum.at(cmax, cols, absv * r[rows])
    if np.any(cmax == 0.0):
        raise ValueError("matrix has an empty column; singular")
    c = 1.0 / cmax

    smlnum = np.finfo(np.float64).tiny
    bignum = 1.0 / smlnum
    rowcnd = max(r.min() / r.max(), smlnum) if a.m else 1.0
    colcnd = max(c.min() / c.max(), smlnum) if a.n else 1.0
    del bignum
    return r, c, rowcnd, colcnd, amax


def laqgs(a: CSRMatrix, r, c, rowcnd, colcnd, amax):
    """Decide whether to apply the scalings (dlaqgs_dist thresholds:
    apply row scaling if rowcnd < 0.1, col if colcnd < 0.1, or if amax
    is out of the safe range).  Returns (equed, r_eff, c_eff) where
    equed ∈ {'N','R','C','B'} and r_eff/c_eff are the applied scalings
    (ones when not applied)."""
    thresh = 0.1
    small = np.finfo(np.float64).tiny / np.finfo(np.float64).eps
    large = 1.0 / small
    do_row = rowcnd < thresh or amax < small or amax > large
    do_col = colcnd < thresh
    if do_row and do_col:
        equed = "B"
    elif do_row:
        equed = "R"
    elif do_col:
        equed = "C"
    else:
        equed = "N"
    r_eff = r if do_row else np.ones(a.m)
    c_eff = c if do_col else np.ones(a.n)
    return equed, r_eff, c_eff
