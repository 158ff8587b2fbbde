"""Multifrontal execution plan: per-supernode index maps + buckets.

This is the replacement for the reference's distributed LU
metadata (dLocalLU_t index arrays, SRC/superlu_ddefs.h:97-263, and the
static schedule SRC/dstatic_schedule.c).  Each supernode s owns a dense
*frontal matrix* over the index set I_s = cols(s) ∪ struct(s); the
numeric factorization is then a fixed DAG of dense block ops:

    assemble (scatter A entries + extend-add child updates)
    → partial LU of the leading w×w block  (panel factor)
    → TRSM L21/U12
    → Schur update C = A22 − L21·U12        (GEMM)
    → pass C to the parent front (extend-add)

Ragged sizes are padded to bucket shapes (wb, mb) so fronts of one
shape run as one batch (SURVEY.md §7 "padding-to-buckets"; the
reference's analog constraint is maxsup ≤ MAX_SUPER_SIZE=512,
SRC/superlu_defs.h:139).  Padding in the pivot block carries an
identity diagonal so the padded partial LU equals the unpadded one.

All maps here are host-side numpy, computed once per sparsity pattern
and cached in the FactorPlan (the SamePattern reuse rung,
SRC/superlu_defs.h:577-598).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .symbolic import SymbolicFactorization


def front_flops(w, r):
    """True flops to factor a front of pivot width w with r off-block
    rows: partial LU (2/3 w³) + two TRSMs (w²r each) + GEMM (2wr²).
    Vectorized; the single cost model shared by factor_flops and the
    amalgamation merge bound (plan/symbolic.py amalgamate)."""
    wf = np.asarray(w, dtype=np.float64)
    rf = np.asarray(r, dtype=np.float64)
    return 2.0 / 3.0 * wf**3 + 2.0 * wf * wf * rf + 2.0 * wf * rf * rf


def bucketize(values: np.ndarray, buckets: tuple) -> np.ndarray:
    """Smallest bucket ≥ value.  The bucket ladder is extended
    geometrically (×1.5, rounded up to 256) past its configured top so
    arbitrarily large separator fronts (e.g. audikw_1-scale) plan
    rather than error."""
    b = list(buckets)
    vmax = int(values.max()) if len(values) else 0
    while b[-1] < vmax:
        b.append(int(-(-int(b[-1] * 1.5) // 256) * 256))
    b = np.asarray(b, dtype=np.int64)
    idx = np.searchsorted(b, values, side="left")
    return b[idx]


@dataclasses.dataclass
class FrontalPlan:
    sym: SymbolicFactorization
    n: int
    # per-supernode geometry
    w: np.ndarray        # supernode widths
    r: np.ndarray        # off-block rows
    m: np.ndarray        # w + r (true front size)
    wb: np.ndarray       # padded pivot-block width
    mb: np.ndarray       # padded front size
    I: List[np.ndarray]  # global index set per supernode (sorted)
    # A-value assembly, grouped per supernode: indices into the COO
    # value array of the (scaled, unpermuted-order) input matrix, and
    # destination (row, col) local positions in the *unpadded* front
    a_src: List[np.ndarray]
    a_lr: List[np.ndarray]
    a_lc: List[np.ndarray]
    # extend-add: child struct positions within parent's I (length r[s])
    ea_map: List[np.ndarray]
    # level schedule over the supernodal etree
    level_supernodes: List[np.ndarray]
    # flop estimate of the true (unpadded) factorization
    factor_flops: float

    @property
    def nsuper(self) -> int:
        return self.sym.nsuper


def build_frontal_plan(sym: SymbolicFactorization,
                       coo_rows: np.ndarray, coo_cols: np.ndarray,
                       width_buckets: tuple, front_buckets: tuple,
                       ) -> FrontalPlan:
    """coo_rows/cols: the input matrix pattern in FINAL (postordered,
    permuted) labels, in the caller's value-array order."""
    part = sym.part
    ns = part.nsuper
    xsup = part.xsup
    n = int(xsup[-1])

    w = np.diff(xsup).astype(np.int64)
    r = np.array([len(s) for s in sym.struct], dtype=np.int64)
    m = w + r
    wb = bucketize(w, width_buckets)
    # the front must hold the padded pivot block plus all true rows
    mb = bucketize(np.maximum(wb + r, m), front_buckets)

    I = [np.concatenate([np.arange(xsup[s], xsup[s + 1]), sym.struct[s]])
         for s in range(ns)]

    # One keyed searchsorted resolves EVERY (supernode, global index)
    # -> front position query at once: struct entries of supernode s
    # live at key s·(n+1)+index in one sorted concatenation, so a
    # query batch of mixed supernodes is a single O(Q·log) pass.
    soff = np.concatenate(([0], np.cumsum(r)))
    struct_cat = (np.concatenate(sym.struct) if ns
                  else np.empty(0, dtype=np.int64))
    KEY = np.int64(n + 1)
    skeys = np.repeat(np.arange(ns, dtype=np.int64), r) * KEY + struct_cat

    def positions(sup_of_q: np.ndarray, idx: np.ndarray) -> np.ndarray:
        last_of = xsup[sup_of_q + 1] - 1
        inb = idx <= last_of
        pos = np.empty(len(idx), dtype=np.int64)
        pos[inb] = idx[inb] - xsup[sup_of_q[inb]]
        q = ~inb
        if np.any(q):
            j = np.searchsorted(skeys, sup_of_q[q] * KEY + idx[q])
            pos[q] = w[sup_of_q[q]] + (j - soff[sup_of_q[q]])
        return pos

    # --- A-entry ownership: supernode of min(i,j) ---
    k = np.minimum(coo_rows, coo_cols)
    owner = part.supno[k]
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(ns + 1))
    own_sorted = owner[order]
    lr_all = positions(own_sorted, coo_rows[order])
    lc_all = positions(own_sorted, coo_cols[order])
    a_src = [order[bounds[s]:bounds[s + 1]] for s in range(ns)]
    a_lr = [lr_all[bounds[s]:bounds[s + 1]] for s in range(ns)]
    a_lc = [lc_all[bounds[s]:bounds[s + 1]] for s in range(ns)]

    # --- extend-add maps: positions of struct(s) inside parent front ---
    has_ea = (part.sparent >= 0) & (r > 0)
    ea_sup = np.repeat(part.sparent[has_ea], r[has_ea])
    ea_idx = struct_cat[np.repeat(has_ea, r)]
    ea_all = positions(ea_sup, ea_idx)
    ea_bounds = np.concatenate(([0], np.cumsum(r[has_ea])))
    ea_map: List[np.ndarray] = []
    ei = 0
    for s in range(ns):
        if has_ea[s]:
            ea_map.append(ea_all[ea_bounds[ei]:ea_bounds[ei + 1]])
            ei += 1
        else:
            ea_map.append(np.empty(0, dtype=np.int64))

    # --- level schedule ---
    nlev = int(part.levels.max()) + 1 if ns else 0
    level_supernodes = [np.where(part.levels == lv)[0] for lv in range(nlev)]

    factor_flops = float(np.sum(front_flops(w, r)))

    return FrontalPlan(sym=sym, n=n, w=w, r=r, m=m, wb=wb, mb=mb, I=I,
                       a_src=a_src, a_lr=a_lr, a_lc=a_lc, ea_map=ea_map,
                       level_supernodes=level_supernodes,
                       factor_flops=factor_flops)
