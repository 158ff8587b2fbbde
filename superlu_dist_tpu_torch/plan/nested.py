"""Nested-dissection ordering via BFS level-set bisection (host).

Analog slot of METIS_AT_PLUS_A / ParMETIS in get_perm_c_dist
(SRC/get_perm_c.c:91,489; SRC/get_perm_c_parmetis.c:255).  A
vectorized-numpy recursive bisection: pseudo-peripheral BFS, split the
level structure at the median, middle level set is the separator,
separator ordered last.  Each recursion step extracts the induced
subgraph with *local* labels, so per-block work is O(nnz_block) and the
whole ordering is O(nnz·log n).  Near-optimal on mesh-like graphs
(which is what the solver's headline benchmarks factor).  The etree
this ordering induces also seeds the subtree-affine device zones of
the distributed schedule (ops/batched.py _zone_assignment), the way
ParMETIS separator sizes seed symbfact_dist in the reference.
"""

from __future__ import annotations

import numpy as np


def _neighbors_flat(indptr, indices, frontier):
    """Concatenated adjacency of `frontier` (local labels)."""
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    offs = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])),
                     counts)
    return indices[offs + np.arange(total)]


def _bfs_levels(indptr, indices, n, source):
    level = np.full(n, -1, dtype=np.int64)
    level[source] = 0
    frontier = np.array([source], dtype=np.int64)
    lev = 0
    while len(frontier):
        lev += 1
        nb = _neighbors_flat(indptr, indices, frontier)
        nb = nb[level[nb] == -1]
        if len(nb) == 0:
            break
        nb = np.unique(nb)
        level[nb] = lev
        frontier = nb
    return level


def _pseudo_peripheral(indptr, indices, n):
    src = 0
    last_ecc = -1
    level = _bfs_levels(indptr, indices, n, src)
    for _ in range(4):
        reached = level >= 0
        ecc = int(level[reached].max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        src = int(np.where(level == ecc)[0][0])
        level = _bfs_levels(indptr, indices, n, src)
    return level


def _induced_subgraph(indptr, indices, nodes):
    """CSR of the subgraph induced by sorted `nodes`, relabeled 0..k-1.
    O(Σ degree(nodes))."""
    starts = indptr[nodes]
    counts = indptr[nodes + 1] - starts
    total = int(counts.sum())
    flat = np.empty(total, dtype=indices.dtype)
    offs = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])),
                     counts)
    flat = indices[offs + np.arange(total)]
    # keep only edges whose endpoint is in `nodes`; relabel via
    # searchsorted on the sorted node list
    pos = np.searchsorted(nodes, flat)
    pos_ok = (pos < len(nodes))
    keep = np.zeros(total, dtype=bool)
    keep[pos_ok] = nodes[pos[pos_ok]] == flat[pos_ok]
    # rebuild indptr
    row_of = np.repeat(np.arange(len(nodes)), counts)
    rows_kept = row_of[keep]
    new_indices = pos[keep]
    new_indptr = np.concatenate(
        ([0], np.cumsum(np.bincount(rows_kept, minlength=len(nodes)))))
    return new_indptr.astype(np.int64), new_indices.astype(np.int64)


def nd_order(indptr: np.ndarray, indices: np.ndarray, n: int,
             leaf_size: int = 48, threads: int = 1) -> np.ndarray:
    """Returns order[k] = k-th pivot (old label).  Dispatches to the
    native C++ pass (csrc/slu_host.cpp slu_ndorder — thread-parallel
    recursion halves, the ParMETIS-slot parallel ordering); this numpy
    implementation is the fallback and the bit-identical test oracle.
    `threads` comes from Options.nd_threads (SUPERLU_ND_THREADS)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    from ..utils.native import native_or_none
    native = native_or_none()
    if native is not None:
        return native.nd_order(indptr, indices, n, leaf_size,
                               max(1, threads))
    return nd_order_py(indptr, indices, n, leaf_size)


def nd_order_py(indptr: np.ndarray, indices: np.ndarray, n: int,
                leaf_size: int = 48) -> np.ndarray:
    """Pure-numpy recursive bisection (oracle/fallback)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    pos = 0

    # stack items: ("solve", indptr, indices, global_labels) or
    # ("emit", global_labels); separators are emitted after both halves.
    stack = [("solve", indptr, indices,
              np.arange(n, dtype=np.int64))]
    while stack:
        item = stack.pop()
        if item[0] == "emit":
            labels = item[1]
            out[pos:pos + len(labels)] = labels
            pos += len(labels)
            continue
        _, ip, ix, labels = item
        k = len(labels)
        if k <= leaf_size:
            out[pos:pos + k] = labels
            pos += k
            continue
        level = _pseudo_peripheral(ip, ix, k)
        unreached = np.where(level < 0)[0]
        if len(unreached):
            # disconnected: split off the unreached component(s)
            sub_ip, sub_ix = _induced_subgraph(ip, ix, unreached)
            stack.append(("solve", sub_ip, sub_ix, labels[unreached]))
            reached = np.where(level >= 0)[0]
            sub_ip, sub_ix = _induced_subgraph(ip, ix, reached)
            stack.append(("solve", sub_ip, sub_ix, labels[reached]))
            continue
        maxlev = int(level.max())
        if maxlev < 2:
            out[pos:pos + k] = labels
            pos += k
            continue
        counts = np.bincount(level, minlength=maxlev + 1)
        cum = np.cumsum(counts)
        split = int(np.clip(np.searchsorted(cum, k / 2), 1, maxlev - 1))
        sep = np.where(level == split)[0]
        left = np.where(level < split)[0]
        right = np.where(level > split)[0]
        stack.append(("emit", labels[sep]))
        for part in (right, left):
            sub_ip, sub_ix = _induced_subgraph(ip, ix, part)
            stack.append(("solve", sub_ip, sub_ix, labels[part]))

    assert pos == n
    return out
