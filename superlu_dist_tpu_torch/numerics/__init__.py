"""numerics/ — the numerical-trust layer.

GESP secures stability before the numeric phase and never pivots at
runtime; this package is the verification layer that hedges that bet
(pdgscon / pdgsrfs in the reference):

  errors.py   typed taxonomy of wrong-answer failure modes
  gscon.py    Hager-Higham rcond estimation riding the resident packed
              solve — zero extra factorizations
  ledger.py   tiny-pivot perturbations as first-class per-
              factorization data (count, locations, magnitude)
  policy.py   ConditionPolicy(serve|stamp|refuse): rcond thresholds
              feeding refusal, stamping and the escalation ladder
  gauntlet.py hard-matrix corpus and the zero-silent-wrong-answers
              classification
  health.py   the pivot-growth probe and the health-event seam
              (ROADMAP item 14)
"""

from .errors import (
    InvalidInputError,
    NumericalError,
    SingularMatrixError,
    StructurallySingularError,
)
from .gscon import ensure_rcond, estimate_rcond, one_norm
from .ledger import (
    PerturbationLedger,
    PerturbedResult,
    build_ledger,
    stamp_perturbed,
)
from .policy import ConditionPolicy, cond_estimate_enabled

__all__ = [
    "ConditionPolicy",
    "InvalidInputError",
    "NumericalError",
    "PerturbationLedger",
    "PerturbedResult",
    "SingularMatrixError",
    "stamp_perturbed",
    "StructurallySingularError",
    "build_ledger",
    "cond_estimate_enabled",
    "ensure_rcond",
    "estimate_rcond",
    "one_norm",
]
