"""Minimum-degree ordering (host, Python fallback).

Analog of the reference's genmmd (SRC/mmd.c, ~1k LoC of multiple
minimum degree).  This is a clean-room set-based exact-external-degree
minimum degree with mass elimination of indistinguishable supervariables
— adequate for small/medium patterns; large patterns route to the
nested-dissection ordering (plan/nested.py) or the native C++ AMD.
"""

from __future__ import annotations

import heapq

import numpy as np


def md_order(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Exact minimum-degree on a symmetric pattern.  Returns `order`
    with order[k] = k-th pivot (old label); i.e. the inverse of the
    perm_c convention."""
    adj = [set() for _ in range(n)]
    for j in range(n):
        for p in range(indptr[j], indptr[j + 1]):
            i = int(indices[p])
            if i != j:
                adj[i].add(j)
                adj[j].add(i)

    alive = np.ones(n, dtype=bool)
    rep_members = {j: [j] for j in range(n)}
    heap = [(len(adj[j]), j) for j in range(n)]
    heapq.heapify(heap)
    order = []

    while heap:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != len(adj[v]):
            continue  # stale entry
        # eliminate supervariable v: neighbors become a clique
        nbrs = adj[v]
        for u in nbrs:
            adj[u].discard(v)
        nbr_list = list(nbrs)
        for u in nbr_list:
            adj[u] |= nbrs
            adj[u].discard(u)
        # mass elimination: merge indistinguishable neighbors
        # (same closed adjacency) into supervariables
        sig = {}
        for u in nbr_list:
            key = (len(adj[u]), )
            sig.setdefault(key, []).append(u)
        for _, group in sig.items():
            if len(group) < 2:
                continue
            base = group[0]
            base_closed = adj[base] | {base}
            for u in group[1:]:
                if not alive[u]:
                    continue
                if (adj[u] | {u}) == base_closed:
                    # absorb u into base
                    alive[u] = False
                    rep_members[base].extend(rep_members.pop(u))
                    for t in adj[u]:
                        adj[t].discard(u)
                    adj[u] = set()
        alive[v] = False
        order.extend(rep_members.pop(v))
        adj[v] = set()
        for u in nbr_list:
            if alive[u]:
                heapq.heappush(heap, (len(adj[u]), u))

    out = np.asarray(order, dtype=np.int64)
    assert len(out) == n
    return out


def amd_order(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Dispatch: native C++ AMD when available, else Python MD for
    small n, else nested dissection."""
    from ..utils.native import native_or_none
    native = native_or_none()
    if native is not None:
        return native.amd_order(indptr, indices, n)
    if n <= 4000:
        return md_order(indptr, indices, n)
    from .nested import nd_order
    return nd_order(indptr, indices, n)
