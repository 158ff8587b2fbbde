"""Supernodal symbolic factorization (host).

Analog of symbfact (SRC/symbfact.c:81) producing the compressed L/U
graphs of Glu_freeable_t (SRC/superlu_defs.h:494-505).  Because the device
build plans on the symmetrized pattern B = pattern(A)+pattern(A)ᵀ
(SURVEY.md §7), L and Uᵀ share one structure and a single supernodal
union pass over the (postordered) supernodal etree suffices:

    struct(s) = ( rows(B, cols(s)) ∪ ⋃_{c child of s} struct(c) )
                 \\ {i ≤ last col of s}

struct(s) is the sorted set of off-supernode row indices of the L panel
of s (equally: column indices of the U panel).  The invariant
struct(c) ⊆ cols(parent) ∪ struct(parent) — guaranteed by etree theory
plus column contiguity of supernodes — is what makes the multifrontal
extend-add maps (plan/frontal.py) well-defined; it is asserted in
tests/test_plan.py.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .supernodes import SupernodePartition


@dataclasses.dataclass
class SymbolicFactorization:
    part: SupernodePartition
    struct: List[np.ndarray]   # per-supernode sorted off-block row indices
    children: List[np.ndarray]  # per-supernode child supernode ids

    @property
    def nsuper(self) -> int:
        return self.part.nsuper

    def lu_nnz(self) -> int:
        """nnz(L+U) counted like dQuerySpace_dist: dense w×w diagonal
        blocks + both panels."""
        xsup = self.part.xsup
        total = 0
        for s in range(self.nsuper):
            w = int(xsup[s + 1] - xsup[s])
            r = len(self.struct[s])
            total += w * w + 2 * w * r
        return total


def symbolic_factorize(b_indptr: np.ndarray, b_indices: np.ndarray,
                       part: SupernodePartition,
                       threads: int = 0) -> SymbolicFactorization:
    """B is the symmetrized pattern CSR in the final (postordered)
    column order.  Dispatches to the native union pass
    (csrc/slu_host.cpp slu_symbfact_*); Python fallback below.

    threads: 0 = auto (level-parallel native pass, the symbfact_dist
    analog, when the supernode count justifies it), 1 = serial, k > 1
    = exactly k worker threads.  Output is identical either way."""
    from ..utils.native import native_or_none
    native = native_or_none()
    if native is not None:
        import os
        n = len(b_indptr) - 1
        if threads == 0:
            # auto: the union pass is memory-bandwidth-bound, so
            # threads only pay off on patterns with very large
            # supernode populations (audikw_1-class 3D meshes)
            threads = (min(8, os.cpu_count() or 1)
                       if part.nsuper >= 32768 else 1)
        struct = native.symbfact(
            n, b_indptr, b_indices, part.nsuper,
            np.ascontiguousarray(part.xsup, dtype=np.int64),
            np.ascontiguousarray(part.sparent, dtype=np.int64),
            threads=threads)
        return SymbolicFactorization(
            part=part, struct=struct,
            children=_child_lists(part))
    return symbolic_factorize_py(b_indptr, b_indices, part)


def _child_lists(part: SupernodePartition) -> List[np.ndarray]:
    children: List[list] = [[] for _ in range(part.nsuper)]
    for s in range(part.nsuper):
        p = part.sparent[s]
        if p != -1:
            children[p].append(s)
    return [np.asarray(c, dtype=np.int64) for c in children]


def amalgamate(sym: SymbolicFactorization, tau: float,
               cap: int) -> SymbolicFactorization:
    """Supernode amalgamation: merge a supernode into its parent when
    the parent is the immediately-following supernode (column
    contiguity) and the true-flop growth stays within `tau`.

    The reference only relaxes at the leaves (relax_snode,
    SRC/sp_ienv.c sp_ienv(2)); on an accelerator the trade is much more
    favorable — every merge removes a whole sequential level-batch
    step (group dispatch + its per-column panel loop) at the cost of
    explicit zeros that the matrix units churn through for free — so merging
    is applied over the whole tree, CHOLMOD-style.

    Correctness: merging rightmost child s into parent p keeps the
    multifrontal invariants — merged columns are contiguous, merged
    struct is struct(p) (since struct(s) ⊆ cols(p) ∪ struct(p)), and
    grandchild extend-adds still land inside the merged front.

    The growth bound is GLOBAL: each group tracks the sum of its
    members' original front flops, and a merge must keep the merged
    front within (1+tau)× that sum, so total factorization flops grow
    at most (1+tau)× overall."""
    part = sym.part
    ns = part.nsuper
    if ns <= 1 or tau <= 0:
        return sym
    from .etree import tree_levels_from_leaves
    # deferred import: frontal.py imports SymbolicFactorization from
    # this module at top level
    from .frontal import front_flops as f

    xsup = part.xsup
    w = np.diff(xsup).astype(np.int64)
    r = np.array([len(t) for t in sym.struct], dtype=np.int64)
    sparent = part.sparent

    gw = w.copy()                    # accumulated group width (top = s)
    forig = f(w, r)
    absorb = np.zeros(ns, dtype=bool)   # absorb[s]: s merged into s+1
    for s in range(ns - 1):
        if sparent[s] != s + 1:
            continue
        W = gw[s] + w[s + 1]
        if W > cap:
            continue
        fo = forig[s] + f(w[s + 1], r[s + 1])
        if f(W, r[s + 1]) <= (1.0 + tau) * fo:
            absorb[s] = True
            gw[s + 1] += gw[s]
            forig[s + 1] += forig[s]

    if not absorb.any():
        return sym
    tops = np.flatnonzero(~absorb)
    new_ns = len(tops)
    new_xsup = np.concatenate([[0], xsup[tops + 1]]).astype(np.int64)
    new_supno = np.repeat(np.arange(new_ns, dtype=np.int64),
                          np.diff(new_xsup))
    group_of = np.searchsorted(tops, np.arange(ns))  # orig sup -> group
    new_sparent = np.full(new_ns, -1, dtype=np.int64)
    for k, t in enumerate(tops):
        p = sparent[t]
        new_sparent[k] = -1 if p == -1 else group_of[p]
    new_part = SupernodePartition(
        new_ns, new_xsup, new_supno, new_sparent,
        tree_levels_from_leaves(new_sparent))
    return SymbolicFactorization(
        part=new_part,
        struct=[sym.struct[t] for t in tops],
        children=_child_lists(new_part))


def symbolic_factorize_py(b_indptr: np.ndarray, b_indices: np.ndarray,
                          part: SupernodePartition) -> SymbolicFactorization:
    """Pure-Python fallback / test oracle for symbolic_factorize."""
    ns = part.nsuper
    xsup = part.xsup
    children: List[list] = [[] for _ in range(ns)]
    for s in range(ns):
        p = part.sparent[s]
        if p != -1:
            children[p].append(s)

    struct: List[np.ndarray] = [None] * ns  # type: ignore
    for s in range(ns):
        first, last = int(xsup[s]), int(xsup[s + 1] - 1)
        pieces = [b_indices[b_indptr[j]:b_indptr[j + 1]]
                  for j in range(first, last + 1)]
        pieces += [struct[c] for c in children[s]]
        rows = np.concatenate(pieces) if pieces else np.empty(0, np.int64)
        rows = np.unique(rows)
        struct[s] = rows[rows > last].astype(np.int64)

    return SymbolicFactorization(
        part=part,
        struct=struct,
        children=[np.asarray(c, dtype=np.int64) for c in children],
    )
