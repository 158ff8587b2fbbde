"""Iterative refinement (pdgsrfs analog, SRC/pdgsrfs.c:124).

Classic Wilkinson loop on the host: r = b − A·x accumulated in the
refine dtype (the psgsrfs_d2 mixed-precision strategy when the
factorization ran in a lower precision, SRC/psgsrfs_d2.c:229), solve
A·δ = r with the existing factorization on the device, x += δ, until
the componentwise backward error `berr` reaches eps or stops halving.
The residuals are scipy CSR products; only the solves touch the card.
Complex systems refine in complex, with berr max_i |r_i| / (|A||x| +
|b|)_i over the moduli.
"""

from __future__ import annotations

import numpy as np

from ..device import dtype_info


def _refine_dtype(opts, sys_dtype):
    """The accumulator dtype per the resolved residual mode: PLAIN
    accumulates in the working (factor) precision, FP64 in
    refine_dtype.  DOUBLEWORD on this host loop accumulates in native
    float64, which satisfies the same contract (the residual carries
    at least twice the factor precision).  A complex system (matrix
    or right-hand side) makes the accumulator complex of the same
    precision: the mode names the precision, the system its realness."""
    from ..precision.policy import ResidualMode, resolve_residual_mode
    mode = resolve_residual_mode(opts)
    if mode == ResidualMode.PLAIN.value:
        # the working precision is the sweep's: float32 for a bfloat16
        # factor (numpy has no bfloat16)
        base = dtype_info(opts.factor_dtype).working.numpy
    elif mode == ResidualMode.DOUBLEWORD.value:
        base = np.dtype(np.float64)
    else:
        base = dtype_info(opts.refine_dtype).working.numpy
    if np.issubdtype(np.dtype(sys_dtype), np.complexfloating):
        base = np.promote_types(base, np.complex64)
    return base


def _operands(lu, rdt):
    """A and |A| in refine precision, cached on the handle (the
    FACTORED rung exists for repeated solves).  A real A stays real
    under a complex accumulator: `b − A·x` promotes to the same complex
    residual without doubling the cached matrix."""
    adt = rdt
    if rdt.kind == "c" and lu.a.dtype.kind != "c":
        adt = np.dtype(rdt.char.lower())
    cache = lu.refine_cache
    ent = cache.get(adt)
    if ent is None:
        with lu.cache_lock:
            ent = cache.get(adt)
            if ent is None:
                asp = lu.a.to_scipy().astype(adt)
                ent = {"asp": asp, "abs_a": abs(asp)}
                cache[adt] = ent
    return ent["asp"], ent["abs_a"]


def iterative_refine(lu, b, x, solve_factored, to_factor_rhs,
                     from_factor_sol, trans: bool = False):
    """Returns (x, berr, steps, stalled)."""
    opts = lu.effective_options
    rdt = _refine_dtype(opts, np.promote_types(lu.a.dtype, b.dtype))
    eps = dtype_info(rdt).eps
    asp, abs_a = _operands(lu, rdt)
    if trans:
        asp = asp.T
        abs_a = abs_a.T
    xk = x.astype(rdt)
    bk = b.astype(rdt)

    def berr_of(r, xv):
        # componentwise backward error: max_i |r_i| / (|A||x| + |b|)_i
        denom = abs_a @ np.abs(xv) + np.abs(bk)
        denom = np.where(denom == 0.0, 1.0, denom)
        return float(np.max(np.abs(r) / denom))

    r = bk - asp @ xk
    berr = berr_of(r, xk)
    steps = 0
    stalled = False
    for _ in range(opts.max_refine_steps):
        if berr <= eps:
            break
        d = from_factor_sol(solve_factored(lu, to_factor_rhs(r)))
        x_new = xk + d
        r_new = bk - asp @ x_new
        berr_new = berr_of(r_new, x_new)
        steps += 1
        if not np.isfinite(berr_new) or berr_new >= berr * 0.5:
            stalled = True
            if berr_new < berr:
                xk, berr = x_new, berr_new
            break
        xk, r, berr = x_new, r_new, berr_new
    # a stall is "berr stopped halving short of eps" — not a loop whose
    # last halving already landed at machine precision
    stalled = stalled and not bool(berr <= eps)
    return xk, berr, steps, stalled
