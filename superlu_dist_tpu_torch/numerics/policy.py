"""Condition-aware policy: the rcond estimate (numerics/gscon.py)
turned into decisions at three thresholds.

  rcond <= floor          numerically singular: SingularMatrixError in
                          EVERY mode — a garbage solve is never an
                          outcome.  floor defaults to eps(refine_dtype):
                          below it not one digit of the solution is
                          trustworthy after refinement.
  rcond <= stamp          ill-conditioned: the mode decides — 'serve'
                          silently, 'stamp' (default) labels results,
                          'refuse' raises.  Independent of mode, the
                          escalation ladder climbs a rung before the
                          first solve (models/gssvx._condition_gate).
                          stamp defaults to sqrt(eps(refine_dtype)).
  otherwise               well-conditioned: no policy action.

The knobs are the reference's flags (SLU_COND_POLICY / _FLOOR /
_STAMP); `from_env()` is cheap enough to call per factorization.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import flags
from ..device import dtype_info
from .errors import SingularMatrixError

_MODES = ("serve", "stamp", "refuse")


@dataclasses.dataclass(frozen=True)
class ConditionPolicy:
    mode: str = "stamp"
    floor: float = 0.0          # 0 = auto: eps(refine_dtype)
    stamp: float = 0.0          # 0 = auto: sqrt(eps(refine_dtype))

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"SLU_COND_POLICY={self.mode!r}: "
                             f"expected one of {_MODES}")

    @classmethod
    def from_env(cls) -> "ConditionPolicy":
        return cls(
            mode=flags.env_str("SLU_COND_POLICY", "stamp").strip()
            or "stamp",
            floor=flags.env_float("SLU_COND_FLOOR", 0.0),
            stamp=flags.env_float("SLU_COND_STAMP", 0.0))

    def floor_for(self, refine_dtype) -> float:
        if self.floor > 0.0:
            return self.floor
        return dtype_info(refine_dtype).eps

    def stamp_for(self, refine_dtype) -> float:
        if self.stamp > 0.0:
            return self.stamp
        # the square root in the dtype's own precision, as the
        # reference takes it of np.finfo's eps
        info = dtype_info(refine_dtype)
        return float(np.sqrt(np.asarray(info.eps,
                                        dtype=info.working.numpy)))

    def classify(self, rcond, refine_dtype) -> str:
        """'ok' | 'ill' | 'singular' for an estimate (None -> 'ok': no
        estimate means no policy action, never a refusal).  A NaN
        estimate is 'singular': it must not slip past the floor."""
        if rcond is None:
            return "ok"
        r = float(rcond)
        if not r > self.floor_for(refine_dtype):
            return "singular"
        if r <= self.stamp_for(refine_dtype):
            return "ill"
        return "ok"

    def enforce(self, rcond, refine_dtype, *, where: str = "") -> str:
        """Raise SingularMatrixError when the estimate falls under the
        floor (any mode) or under the stamp threshold in 'refuse' mode;
        otherwise return the classification."""
        cls = self.classify(rcond, refine_dtype)
        if cls == "singular":
            raise SingularMatrixError(
                f"matrix is numerically singular{where}: estimated "
                f"rcond {float(rcond):.3e} <= floor "
                f"{self.floor_for(refine_dtype):.3e} — refusing to "
                "serve a meaningless solve", rcond=float(rcond))
        if cls == "ill" and self.mode == "refuse":
            raise SingularMatrixError(
                f"matrix is too ill-conditioned{where}: estimated "
                f"rcond {float(rcond):.3e} <= "
                f"{self.stamp_for(refine_dtype):.3e} and "
                "SLU_COND_POLICY=refuse", rcond=float(rcond))
        return cls


def cond_estimate_enabled() -> bool:
    """The eager-estimation master switch (SLU_COND_ESTIMATE)."""
    return flags.env_str("SLU_COND_ESTIMATE", "0").strip() == "1"
