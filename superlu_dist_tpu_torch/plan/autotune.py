"""Bucket autotuning (the sp_ienv tunables analog, SURVEY.md §7 item 6).

The padded-front execution quantizes supernode widths w and front sizes
m = w + r onto bucket grids (Options.width_buckets/front_buckets).
Coarse grids waste FLOPs/HBM on padding; fine grids multiply the number
of (level, bucket) groups — program size and, compile time.
This module picks grids from the ACTUAL (w, m) distribution of a
pattern by weighted 1-D k-median dynamic programming: choose at most K
bucket values minimizing total padded cost, where the cost of a front
is the dense partial-LU flop model

    cost(w', m') = w'²·m' + w'·(m'−w')²     (w', m' = bucketed sizes)

Usage:
    plan = plan_factorization(a, opts)
    opts2 = autotuned_options(plan, opts)        # tightened grids
    plan2 = plan_factorization(a, opts2)         # re-plan with them
or one-shot: plan_factorization(a, opts, autotune=True).
"""

from __future__ import annotations

import numpy as np


def _dp_buckets(values: np.ndarray, weights: np.ndarray,
                max_buckets: int, power: float) -> list:
    """Choose ≤ max_buckets bucket boundaries from the unique sorted
    `values` minimizing the RELATIVE padding cost
    Σ weights·(bucket/value)^power, where each value maps to the
    smallest bucket ≥ it.  The relative form is essential: with an
    absolute cost the handful of giant separator fronts dominates the
    objective and the DP happily rounds thousands of small leaf
    fronts up by 7× (a real failure observed on 3D meshes — 468 MB of
    update-slab padding from one leaf group).  (bucket/value)^power is
    the per-front flop AND memory inflation factor (power=1 for
    widths, 2 for front sizes), so every front's padding is judged
    against its own true cost.  O(U²·K) DP — U is tiny."""
    uniq = np.unique(values)
    U = len(uniq)
    if U == 0:
        return []
    K = min(max_buckets, U)
    w_of = np.zeros(U)
    for v, wt in zip(values, weights):
        w_of[np.searchsorted(uniq, v)] += wt
    # seg[i,j] = Σ_{t=i..j} w_of[t]·(uniq[j]/uniq[t])^p
    #          = uniq[j]^p · prefix-sums of w_of[t]/uniq[t]^p
    inv = w_of / np.maximum(uniq, 1).astype(float) ** power
    cinv = np.concatenate([[0.0], np.cumsum(inv)])
    seg = np.empty((U, U))
    for j in range(U):
        bp = float(uniq[j]) ** power
        seg[:j + 1, j] = bp * (cinv[j + 1] - cinv[:j + 1])
    INF = np.inf
    dp = np.full((K + 1, U), INF)
    choice = np.zeros((K + 1, U), dtype=np.int64)
    for j in range(U):
        dp[1, j] = seg[0, j]
    for k in range(2, K + 1):
        for j in range(k - 1, U):
            best, arg = INF, -1
            for i in range(k - 2, j):
                c = dp[k - 1, i] + seg[i + 1, j]
                if c < best:
                    best, arg = c, i
            dp[k, j], choice[k, j] = best, arg
    # every bucket multiplies (level, bucket) groups — sequential
    # dispatch steps on the device — so an extra bucket must buy its keep:
    # charge 3% of the no-padding cost (Σw, the cost floor) per bucket
    lam = 0.03 * float(np.sum(w_of))
    best_k = min(range(1, K + 1),
                 key=lambda k: dp[k, U - 1] + lam * k)
    # backtrack
    out = []
    j = U - 1
    k = best_k
    while k >= 1:
        out.append(int(uniq[j]))
        if k == 1:
            break
        j = int(choice[k, j])
        k -= 1
    return sorted(out)


def autotuned_options(plan, options=None, max_width_buckets: int = 10,
                      max_front_buckets: int = 16):
    """Return options with width/front bucket grids fit to this plan's
    supernode population (pattern-keyed, so cacheable alongside the
    plan — the SamePattern rung)."""
    options = options or plan.options
    fp = plan.frontal
    w = np.asarray([int(x) for x in fp.w])
    m = np.asarray([int(x) for x in fp.m])

    # Weight each supernode by its flop share PLUS its scale-normalized
    # storage share.  Flops alone fail at mesh scale: the handful of
    # giant separator fronts carries ~all flops, so the per-bucket
    # penalty (λ ∝ total weight) grows past what the thousands of tiny
    # leaf fronts can justify, the DP folds them into the separators'
    # bucket, and LU/update-slab memory inflates ~25x (observed on the
    # k=64 3D Laplacian: 22k of 22.3k fronts in one (192,1096) bucket,
    # 62 GB padded LU for 1.7 GB true).  Entries are leaf-dominated, so
    # κ·entries (κ equalizing the two totals) restores the leaves'
    # bargaining power and keeps padding a bounded multiple of true
    # storage while still optimizing flops where the flops are.
    flops = w * w * m + w * (m - w) ** 2 + 1.0
    entries = w * (w + 2.0 * (m - w)) + 1.0
    kappa = float(np.sum(flops)) / float(np.sum(entries))
    weight = flops + kappa * entries
    wb = _dp_buckets(w, weight, max_width_buckets, power=1.0)

    # legalize widths first: the blocked LU kernel needs wb ≤ 32 or
    # wb ≡ 0 mod 32 (dense_lu.partial_lu block size), and device tiles
    # like multiples of 8
    def legal_w(v):
        if v > 32:
            return -(-v // 32) * 32
        return -(-v // 8) * 8 if v > 8 else v
    wb = sorted({legal_w(int(v)) for v in wb})

    # front buckets are fit to the sizes the frontal plan will ACTUALLY
    # bucketize — max(width_bucket(w) + r, m) — not to the raw m, so
    # width legalization cannot push fronts past every chosen bucket
    wb_arr = np.asarray(wb)
    wb_of = wb_arr[np.searchsorted(wb_arr, w)]
    m_eff = np.maximum(wb_of + (m - w), m)
    mb = _dp_buckets(m_eff, weight, max_front_buckets, power=2.0)
    mb = sorted({-(-int(v) // 8) * 8 for v in mb})
    return options.replace(width_buckets=tuple(wb),
                           front_buckets=tuple(mb))
