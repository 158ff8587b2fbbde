"""Elimination-tree machinery (host side).

Analog of the reference's etree/postorder utilities (SRC/etree.c,
SRC/sp_colorder.c) and the supernodal column counts that its symbolic
factorization derives (SRC/symbfact.c:81).  This build works on the
*symmetrized* pattern B = pattern(A) + pattern(A)^T (the assumption
already underlying the reference's METIS_AT_PLUS_A / MMD_AT_PLUS_A
orderings): with a nonzero diagonal secured by static pivoting, the LU
fill of A is contained in the Cholesky fill of B, so one symmetric
etree + column-count pass plans both L and U (SURVEY.md §7 design
stance).

All routines take B as a symmetric-pattern scipy-style CSR (indptr,
indices) and run in O(nnz·α) host time.  These are sequential graph
algorithms; a native C++ implementation backs them for large problems
(csrc/), with these Python versions as the portable fallback and test
oracle.
"""

from __future__ import annotations

import numpy as np


def _native():
    """The C++ host library (csrc/slu_host.cpp) or None."""
    from ..utils.native import native_or_none
    return native_or_none()


def etree_symmetric(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Elimination tree of a symmetric-pattern matrix (Liu's algorithm
    with path compression).  Returns parent[j] (or -1 for roots)."""
    nat = _native()
    if nat is not None:
        return nat.etree(indptr, indices, n)
    return etree_symmetric_py(indptr, indices, n)


def etree_symmetric_py(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Pure-Python fallback / test oracle for etree_symmetric."""
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(indptr[j], indptr[j + 1]):
            i = indices[p]
            if i >= j:
                continue
            # follow path from i to the root of its current tree,
            # compressing towards j
            r = i
            while True:
                a = ancestor[r]
                if a == j:
                    break
                ancestor[r] = j
                if a == -1:
                    parent[r] = j
                    break
                r = a
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the forest.  Returns post[k] = k-th column in
    postorder (iterative DFS, children in ascending order)."""
    nat = _native()
    if nat is not None:
        return nat.postorder(np.ascontiguousarray(parent, dtype=np.int64))
    return postorder_py(parent)


def postorder_py(parent: np.ndarray) -> np.ndarray:
    """Pure-Python fallback / test oracle for postorder."""
    n = len(parent)
    # build child lists as head/next arrays (reverse iteration gives
    # ascending-order children when consuming the linked list)
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for j in range(n - 1, -1, -1):
        p = parent[j]
        if p != -1:
            nxt[j] = head[p]
            head[p] = j
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            node = stack[-1]
            child = head[node]
            if child != -1:
                head[node] = nxt[child]  # pop child from list
                stack.append(child)
            else:
                post[k] = node
                k += 1
                stack.pop()
    assert k == n, "parent array is not a forest"
    return post


def relabel_tree(parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """Relabel parent pointers after permuting columns by `post`
    (new label of old column j is invpost[j])."""
    n = len(parent)
    invpost = np.empty(n, dtype=np.int64)
    invpost[post] = np.arange(n, dtype=np.int64)
    newparent = np.full(n, -1, dtype=np.int64)
    for k in range(n):
        p = parent[post[k]]
        newparent[k] = -1 if p == -1 else invpost[p]
    return newparent


def col_counts_postordered(indptr: np.ndarray, indices: np.ndarray,
                           parent: np.ndarray) -> np.ndarray:
    """Column counts |L(:,j)| of the postordered Cholesky factor;
    dispatches to the native library, Python fallback below."""
    nat = _native()
    if nat is not None:
        return nat.col_counts(indptr, indices,
                              np.ascontiguousarray(parent, dtype=np.int64))
    return col_counts_postordered_py(indptr, indices, parent)


def col_counts_postordered_py(indptr: np.ndarray, indices: np.ndarray,
                              parent: np.ndarray) -> np.ndarray:
    """Column counts |L(:,j)| (including the diagonal) of the Cholesky
    factor of a symmetric-pattern matrix whose columns are already in
    postorder (parent[j] > j for all non-roots).

    Gilbert–Ng–Peyton skeleton/leaf counting with path-halving LCA —
    O(nnz·α).  Oracle-tested against brute-force symbolic
    factorization (tests/test_plan.py).
    """
    n = len(parent)
    post = np.arange(n)  # already postordered
    # first[j] = first (postorder-smallest) descendant of j
    first = np.full(n, -1, dtype=np.int64)
    delta = np.zeros(n, dtype=np.int64)
    for k in range(n):
        j = post[k]
        delta[j] = 1 if first[j] == -1 else 0  # leaf of the etree
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]

    maxfirst = np.full(n, -1, dtype=np.int64)
    prevleaf = np.full(n, -1, dtype=np.int64)
    ancestor = np.arange(n, dtype=np.int64)

    def find(q):
        # path-halving find on the ancestor forest
        while ancestor[q] != q:
            ancestor[q] = ancestor[ancestor[q]]
            q = ancestor[q]
        return q

    for k in range(n):
        j = post[k]
        p = parent[j]
        if p != -1:
            delta[p] -= 1
        for t in range(indptr[j], indptr[j + 1]):
            i = indices[t]
            if i <= j:
                continue
            # j is adjacent to row i, i > j: test whether j is a leaf
            # of the row subtree T^r(i)
            if first[j] > maxfirst[i]:
                delta[j] += 1
                maxfirst[i] = first[j]
                pl = prevleaf[i]
                if pl != -1:
                    q = find(pl)
                    delta[q] -= 1
                prevleaf[i] = j
        if p != -1:
            ancestor[j] = p

    # accumulate deltas up the tree
    colcount = delta.copy()
    for j in range(n):
        p = parent[j]
        if p != -1:
            colcount[p] += colcount[j]
    return colcount


def subtree_sizes(parent: np.ndarray) -> np.ndarray:
    """Number of nodes in each subtree (postordered parent array)."""
    n = len(parent)
    size = np.ones(n, dtype=np.int64)
    for j in range(n):
        p = parent[j]
        if p != -1:
            size[p] += size[j]
    return size


def tree_levels_from_leaves(parent: np.ndarray) -> np.ndarray:
    """level[j] = 1 + max(level of children), 0 for leaves.  Valid for
    postordered parents (children have smaller indices)."""
    n = len(parent)
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):
        p = parent[j]
        if p != -1 and level[p] < level[j] + 1:
            level[p] = level[j] + 1
    return level
