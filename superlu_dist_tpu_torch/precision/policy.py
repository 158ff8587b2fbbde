"""Precision policy: which dtype factors, which dtype solves, how the
refinement residual is accumulated, and when to climb.

The reference ships mixed precision as a dedicated expert driver
(`psgssvx_d2`, SRC/psgssvx_d2.c:516: factor in single, refine with a
double residual) and leaves the "what if single wasn't enough"
decision to the caller.  Here the strategy is one value object,

    PrecisionPolicy(factor_dtype, solve_dtype, residual, target_dtype)

installed into Options by `apply()`: the factorization's precision,
the sweep's right-hand-side precision (None follows the factors), how
r = b − A·x accumulates (PLAIN in working precision, DOUBLEWORD in
fp32 (hi, lo) pairs on the fused device loop, FP64 natively), and the
accuracy class sold (Options.refine_dtype).

The ladder is bfloat16 → float32 → float64 (`SLU_PREC_LADDER`
overrides).  models/gssvx.py climbs one rung per failed refinement
contract (cond(A)·eps_factor < 1), and `classify_trigger` names the
health signal behind each climb.  The host refinement loop
(models/refine.py) meets the DOUBLEWORD contract with native float64;
the fused device loop (ops/batched.make_fused_solver) runs the df64
pairs and converges to DF64_EPS.

The reference's module, in the port; its `_eps` goes through
device.dtype_info, which knows bfloat16 without ml_dtypes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .. import flags
from ..device import dtype_info
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
    """eps of a dtype name (bfloat16 included; raises TypeError on a
    name the port does not know)."""
    return dtype_info(dtype_name).eps


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One precision strategy, applied to Options via `apply()`."""

    factor_dtype: str = "float32"
    solve_dtype: Optional[str] = None      # None: follow the factors
    residual: ResidualMode = ResidualMode.DOUBLEWORD
    target_dtype: str = "float64"          # the accuracy class sold

    def __post_init__(self):
        _eps(self.factor_dtype)            # raise early on a typo
        _eps(self.target_dtype)
        if self.solve_dtype is not None:
            _eps(self.solve_dtype)
        if not isinstance(self.residual, ResidualMode):
            object.__setattr__(self, "residual",
                               ResidualMode(self.residual))

    def apply(self, options: Options | None = None) -> Options:
        """Options with this policy installed.  PLAIN maps to the
        SLU_SINGLE refinement rung, the extended-precision modes to
        SLU_DOUBLE."""
        options = options or Options()
        return options.replace(
            factor_dtype=self.factor_dtype,
            solve_dtype=self.solve_dtype,
            residual_mode=self.residual.value,
            refine_dtype=self.target_dtype,
            iter_refine=(IterRefine.SLU_SINGLE
                         if self.residual == ResidualMode.PLAIN
                         else IterRefine.SLU_DOUBLE))

    @classmethod
    def from_options(cls, options: Options) -> "PrecisionPolicy":
        return cls(factor_dtype=options.factor_dtype,
                   solve_dtype=getattr(options, "solve_dtype", None),
                   residual=ResidualMode(
                       resolve_residual_mode(options)),
                   target_dtype=options.refine_dtype)


# -- the escalation ladder -------------------------------------------

_DEFAULT_LADDER = ("bfloat16", "float32", "float64")


def ladder() -> tuple:
    """Factor-dtype rungs, coarse → fine.  SLU_PREC_LADDER overrides
    (comma list of dtype names); entries are validated and sorted by
    decreasing eps, so a shuffled override still climbs correctly."""
    raw = flags.env_str("SLU_PREC_LADDER")
    names = tuple(s.strip() for s in raw.split(",") if s.strip()) \
        or _DEFAULT_LADDER
    return tuple(sorted(names, key=_eps, reverse=True))


def ladder_policies(target_dtype: str = "float64") -> tuple:
    """The rungs as full policies: every rung below the target refines
    through the doubleword residual, the target rung itself
    accumulates plainly (nothing finer exists to borrow precision
    from)."""
    te = _eps(target_dtype)
    out = []
    for d in ladder():
        if _eps(d) < te:
            continue                     # finer than the target: moot
        out.append(PrecisionPolicy(
            factor_dtype=d,
            residual=(ResidualMode.PLAIN if _eps(d) <= te
                      else ResidualMode.DOUBLEWORD),
            target_dtype=target_dtype))
    return tuple(out)


def next_factor_dtype(current: str,
                      ceiling: str = "float64") -> Optional[str]:
    """The next rung UP from `current` (one step, not a jump to the
    top): the coarsest ladder dtype strictly finer than `current` and
    no finer than `ceiling`.  None at the top.  A `current` that is not
    a ladder member (float16) still climbs by eps comparison; a
    ceiling finer than every rung escalates directly to the ceiling."""
    cur_e, ceil_e = _eps(current), _eps(ceiling)
    if cur_e <= ceil_e:
        return None
    best = None
    for d in ladder():
        e = _eps(d)
        if e < cur_e and e >= ceil_e:
            if best is None or e > _eps(best):
                best = d
    return best if best is not None else ceiling


def lower_rungs(target_dtype: str) -> tuple:
    """Ladder rungs strictly coarser than `target_dtype`, finest
    first: the probe order of the serve layer's dtype tiers."""
    te = _eps(target_dtype)
    return tuple(sorted((d for d in ladder() if _eps(d) > te),
                        key=_eps))


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
