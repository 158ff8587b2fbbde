"""Supernode partition: relaxed leaf subtrees + fundamental supernodes.

Analog of the reference's supernode machinery: xsup/supno in
Glu_persist_t (SRC/superlu_defs.h:439-442), relaxed supernodes
(relax = sp_ienv(2), SRC/sp_ienv.c) and the max supernode width cap
(sp_ienv(3), MAX_SUPER_SIZE 512, SRC/superlu_defs.h:139).  On an accelerator the
width cap doubles as the top bucket size for the padded front shapes
(SURVEY.md §7 "padding-to-buckets").

Inputs are postordered: parent[j] > j, subtrees are contiguous index
ranges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .etree import subtree_sizes, tree_levels_from_leaves


@dataclasses.dataclass
class SupernodePartition:
    nsuper: int
    xsup: np.ndarray    # (nsuper+1,) first column of each supernode
    supno: np.ndarray   # (n,) column -> supernode
    sparent: np.ndarray  # (nsuper,) supernodal etree parent (-1 = root)
    levels: np.ndarray  # (nsuper,) level-from-leaves in supernodal etree

    @property
    def widths(self) -> np.ndarray:
        return np.diff(self.xsup)


def find_supernodes(parent: np.ndarray, colcount: np.ndarray,
                    relax: int, max_super: int) -> SupernodePartition:
    """Partition postordered columns into supernodes.

    1. Relaxed supernodes: maximal etree subtrees with ≤ `relax` nodes
       collapse into one supernode (explicit zeros accepted), the
       relax_snode strategy of the reference.
    2. Remaining columns: fundamental supernodes — j joins j-1 when
       parent(j-1) = j and colcount(j-1) = colcount(j)+1 — capped at
       `max_super`.

    Dispatches to the native pass (csrc/slu_host.cpp slu_supernodes,
    bit-identical); this Python loop is the fallback and oracle."""
    n = len(parent)
    if n:
        from ..utils.native import native_or_none
        native = native_or_none()
        if native is not None:
            ns, xsup, supno, sparent = native.supernodes(
                np.ascontiguousarray(parent, dtype=np.int64),
                np.ascontiguousarray(colcount, dtype=np.int64),
                relax, max_super)
            return SupernodePartition(
                ns, xsup, supno, sparent,
                tree_levels_from_leaves(sparent))
    return find_supernodes_py(parent, colcount, relax, max_super)


def find_supernodes_py(parent: np.ndarray, colcount: np.ndarray,
                       relax: int, max_super: int) -> SupernodePartition:
    """Pure-Python fallback / oracle for find_supernodes."""
    n = len(parent)
    if n == 0:
        return SupernodePartition(0, np.zeros(1, dtype=np.int64),
                                  np.empty(0, dtype=np.int64),
                                  np.empty(0, dtype=np.int64),
                                  np.empty(0, dtype=np.int64))
    relax = max(1, min(relax, max_super))
    size = subtree_sizes(parent)

    # maximal relaxed subtrees: size[j] <= relax and (root or parent's
    # subtree too big).  Postorder contiguity: subtree of j is
    # [j-size[j]+1, j].
    snode_root = (size <= relax) & np.where(
        parent >= 0, size[np.clip(parent, 0, n - 1)] > relax, True)

    supno = np.full(n, -1, dtype=np.int64)
    xsup_list = []
    ns = 0
    j = 0
    while j < n:
        # find the maximal relaxed subtree containing j, if any:
        # j is inside the subtree of some relaxed root r ≥ j; since
        # subtrees are contiguous, check if j's enclosing relaxed root
        # exists by walking up while the subtree stays small.
        r = j
        while parent[r] != -1 and size[parent[r]] <= relax:
            r = parent[r]
        if snode_root[r] and size[r] <= relax:
            first = r - size[r] + 1
            # split over-wide relaxed snodes (possible when
            # relax > max_super was clamped equal)
            w = r - first + 1
            start = first
            while w > 0:
                take = min(w, max_super)
                xsup_list.append(start)
                supno[start:start + take] = ns
                ns += 1
                start += take
                w -= take
            j = r + 1
            continue
        # fundamental run starting at j
        xsup_list.append(j)
        supno[j] = ns
        k = j + 1
        while (k < n and parent[k - 1] == k
               and colcount[k - 1] == colcount[k] + 1
               and (k - j) < max_super
               and not (snode_root[k] and size[k] <= relax)
               and size[k] > relax):
            supno[k] = ns
            k += 1
        ns += 1
        j = k

    xsup = np.asarray(xsup_list + [n], dtype=np.int64)

    # supernodal etree: parent supernode of s is the supernode of the
    # etree-parent of s's last column
    sparent = np.full(ns, -1, dtype=np.int64)
    for s in range(ns):
        last = xsup[s + 1] - 1
        p = parent[last]
        sparent[s] = -1 if p == -1 else supno[p]
    levels = tree_levels_from_leaves(sparent)
    return SupernodePartition(ns, xsup, supno, sparent, levels)
