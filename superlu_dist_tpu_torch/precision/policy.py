"""Precision policy: how the refinement residual is accumulated, and
which factor dtype comes next when a low-precision factor fails its
refinement contract.

The reference ships mixed precision as a dedicated expert driver
(`psgssvx_d2`, SRC/psgssvx_d2.c:516: factor in single, refine with a
double residual) and leaves the "what if single wasn't enough"
decision to the caller.  models/gssvx.py climbs one rung of the
ladder below per failed contract (cond(A)·eps_factor < 1), and
`classify_trigger` names the health signal behind each climb.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from ..options import IterRefine, Options


class ResidualMode(enum.Enum):
    """Refinement-residual accumulation strategy (Options.residual_mode
    carries the string value; "auto" resolves to PLAIN or FP64 from
    iter_refine)."""

    PLAIN = "plain"             # working (factor) precision
    DOUBLEWORD = "doubleword"   # two-float df64 (host loop: native f64)
    FP64 = "fp64"               # native refine_dtype accumulation


RESIDUAL_MODES = ("auto",) + tuple(m.value for m in ResidualMode)


def resolve_residual_mode(options: Options) -> str:
    """The one resolution of Options.residual_mode="auto": SLU_SINGLE
    accumulates in working precision (PLAIN), everything else in
    refine_dtype (FP64)."""
    mode = getattr(options, "residual_mode", "auto") or "auto"
    if mode not in RESIDUAL_MODES:
        raise ValueError(
            f"unknown residual_mode {mode!r}; expected one of "
            f"{RESIDUAL_MODES}")
    if mode != "auto":
        return mode
    return (ResidualMode.PLAIN.value
            if options.iter_refine == IterRefine.SLU_SINGLE
            else ResidualMode.FP64.value)


def _eps(dtype_name: str) -> float:
    return float(np.finfo(np.dtype(dtype_name)).eps)


# factor-dtype rungs, coarse → fine (the port factors in float32 and
# float64)
LADDER = ("float32", "float64")


def next_factor_dtype(current: str,
                      ceiling: str = "float64") -> Optional[str]:
    """The next rung UP from `current`: the coarsest ladder dtype
    strictly finer than `current` and no finer than `ceiling`.  None
    at the top; a ceiling finer than every rung escalates directly to
    the ceiling."""
    cur_e, ceil_e = _eps(current), _eps(ceiling)
    if cur_e <= ceil_e:
        return None
    best = None
    for d in LADDER:
        e = _eps(d)
        if e < cur_e and e >= ceil_e:
            if best is None or e > _eps(best):
                best = d
    return best if best is not None else ceiling


# -- health-signal classification ------------------------------------

# pivot growth beyond 1/(16·eps_factor) means the GESP factorization
# amplified entries to within 4 bits of total significand loss
# (numerics/health.pivot_growth watches it at runtime)
_PIVOT_GROWTH_SLACK = 1.0 / 16.0


def classify_trigger(berr: float, *, stalled: bool = False,
                     pivot_growth: Optional[float] = None,
                     factor_eps: Optional[float] = None) -> str:
    """Name the health signal that justified an escalation the caller
    has already decided on (models/gssvx._escalation_core holds the
    berr gate; this orders the EXPLANATION): 'nonfinite',
    'pivot_growth', 'refine_stalled' or 'berr_plateau'."""
    if not np.isfinite(berr):
        return "nonfinite"
    if (pivot_growth is not None and factor_eps
            and pivot_growth * factor_eps > _PIVOT_GROWTH_SLACK):
        return "pivot_growth"
    if stalled:
        return "refine_stalled"
    return "berr_plateau"
