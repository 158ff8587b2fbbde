"""Condition estimation on the resident factors (pdgscon analog).

Hager–Higham one-norm estimation (the LAPACK dlacon iteration,
SRC/pdgscon.c in the reference): estimate ‖A⁻¹‖₁ from a handful of
A⁻¹·x / A⁻ᵀ·x solves (A⁻ᴴ·x for a complex system) against the
factorization the handle already holds, then rcond = 1 / (‖A‖₁ ·
‖A⁻¹‖₁).  The estimator is a host loop over `models.gssvx.solve`
with refinement off, so every inner solve is
the handle's packed solve: the NOTRANS lane runs K3 (csrc/lsum.cu),
the TRANS lane its two batched products, and on the card both replay
the handle's solve graphs (the TRANS lane's are captured at its first
solve).  No new factorization is done.  Cost: at most 2·max_iter + 2
solves per estimate (each iteration one forward and one transpose
solve, plus Higham's closing alternating-sign solve).

The estimate is a LOWER bound on ‖A⁻¹‖₁ (within a factor of ~3 in
practice, Higham 1988), so the derived rcond is an upper bound — it
errs toward serving, and the policy thresholds (numerics/policy.py)
judge orders of magnitude, not digits.

Not ported here: the batched estimator (`inv_norm_est_batch`,
`estimate_rcond_batch`) goes with batch/ (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flags
from ..device import dtype_info, torch_dtype
from ..options import IterRefine, Trans
from ..utils.stats import Stats
from . import health


def one_norm(a) -> float:
    """‖A‖₁ (max column abs sum) of a CSRMatrix, on the host."""
    sp = a.to_scipy()
    if sp.shape[0] == 0:
        return 0.0
    return float(np.max(np.abs(sp).sum(axis=0)))


def _sign(y: np.ndarray) -> np.ndarray:
    """ξ = sign(y) with sign(0) = 1; complex: y/|y| (dzlacon)."""
    if np.issubdtype(y.dtype, np.complexfloating):
        mag = np.abs(y)
        out = np.where(mag == 0, 1.0 + 0.0j, y / np.where(mag == 0, 1.0,
                                                          mag))
        return out.astype(y.dtype)
    return np.where(y >= 0, 1.0, -1.0).astype(y.dtype)


def inv_norm_est(solve_fn, n: int, dtype, max_iter: int = 5) -> float:
    """Hager–Higham estimate of ‖A⁻¹‖₁.  `solve_fn(v, trans)` returns
    A⁻¹·v (trans=False) or A⁻ᵀ·v, A⁻ᴴ·v for a complex system
    (trans=True).  A non-finite solve
    short-circuits to inf — the factors are past saving, and the caller
    maps inf to rcond = 0."""
    if n == 0:
        return 0.0
    dt = np.dtype(dtype)
    x = np.full(n, 1.0 / n, dtype=dt)
    est = 0.0
    j_prev = -1
    for _ in range(max(1, int(max_iter))):
        y = solve_fn(x, False)
        if not np.all(np.isfinite(y)):
            return float("inf")
        est_new = float(np.abs(y).sum())
        xi = _sign(y)
        z = solve_fn(xi, True)
        if not np.all(np.isfinite(z)):
            return float("inf")
        j = int(np.argmax(np.abs(z)))
        # Hager's convergence test: the gradient stopped improving
        # (|z|_inf <= z·x) or the estimate stopped growing
        if est_new <= est or float(np.abs(z[j])) <= abs(
                float(np.real(np.vdot(z, x)))):
            est = max(est, est_new)
            break
        est = est_new
        if j == j_prev:
            break
        j_prev = j
        x = np.zeros(n, dtype=dt)
        x[j] = 1.0
    # Higham's alternating-sign lower bound guards against the gradient
    # iteration's known blind spots (symmetric sign patterns)
    v = np.array([(-1.0) ** i * (1.0 + i / max(n - 1, 1))
                  for i in range(n)], dtype=dt)
    y = solve_fn(v, False)
    if not np.all(np.isfinite(y)):
        return float("inf")
    return max(est, 2.0 * float(np.abs(y).sum()) / (3.0 * n))


def estimate_rcond(lu, anorm: float | None = None,
                   max_iter: int | None = None) -> float:
    """rcond = 1/(‖A‖₁·‖A⁻¹‖₁) for a live factorization handle — every
    inner solve rides the handle's packed solve (refinement off); no
    new factorization.  Returns 0.0 when the estimate says singular to
    working precision (a non-finite solve, or overflow)."""
    from ..models.gssvx import solve
    if max_iter is None:
        max_iter = flags.env_int("SLU_COND_MAXITER", 5)
    eff = lu.effective_options
    base = eff.replace(iter_refine=IterRefine.NOREFINE)
    # the gradient leg of a complex system solves with Aᴴ (dzlacon),
    # a real one with Aᵀ
    cplx = dtype_info(eff.factor_dtype).is_complex
    # the copies share the factors: device_lu with the handle's solve
    # graphs, or a host handle's host_lu
    lu_n = dataclasses.replace(lu, options=base.replace(
        trans=Trans.NOTRANS))
    lu_t = dataclasses.replace(lu, options=base.replace(
        trans=Trans.CONJ if cplx else Trans.TRANS))
    scratch = Stats()   # keep the estimator's wall out of the caller's

    def solve_fn(v, trans):
        return solve(lu_t if trans else lu_n, v, stats=scratch)

    if anorm is None:
        anorm = one_norm(lu.a) if lu.a is not None else None
    if not anorm:       # zero matrix (or no A retained): no estimate
        return 0.0
    # the estimate's vectors: float64 of the factors' realness
    dt = dtype_info(torch.promote_types(torch_dtype(eff.factor_dtype),
                                        torch.float64)).numpy
    ainv = inv_norm_est(solve_fn, lu.n, dt, max_iter=max_iter)
    if not np.isfinite(ainv) or ainv <= 0.0:
        return 0.0
    rcond = 1.0 / (float(anorm) * ainv)
    return float(min(rcond, 1.0))


def ensure_rcond(lu, max_iter: int | None = None) -> float:
    """The handle's rcond, estimated at the first call and cached on
    the handle (`lu.rcond`); later calls, and dataclasses.replace copies
    made after it, read the field."""
    r = getattr(lu, "rcond", None)
    if r is not None:
        return r
    r = estimate_rcond(lu, max_iter=max_iter)
    lu.rcond = r
    health.record("rcond", rcond=r)
    return r
