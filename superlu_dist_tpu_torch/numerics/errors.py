"""Typed numerical-failure taxonomy.

Static pivoting never refuses a matrix at runtime: a structurally
singular input sails through symbolic analysis and a numerically
singular one gets its tiny pivots replaced at sqrt(eps)*anorm
(ops/batched.py), with berr as the only tripwire.  These types make
the failure modes the port detects distinguishable to callers:

  InvalidInputError         the SYSTEM is malformed (non-finite A/b,
                            dimension mismatch, empty) — caller bug,
                            detected at the front door before a
                            factorization runs.  Subclasses
                            ValueError: it is a precondition failure.
  StructurallySingularError the PATTERN admits no LU (empty row or
                            column) — detected at plan time, before
                            equilibration divides by a zero row max.
  SingularMatrixError       the VALUES are singular to working
                            precision (rcond below the floor, or the
                            condition policy refuses an
                            ill-conditioned key) — detected at factor
                            time from the Hager-Higham estimate
                            (numerics/gscon.py, numerics/policy.py),
                            never from a garbage solve.
"""

from __future__ import annotations


class NumericalError(RuntimeError):
    """Base of the numerical-trust taxonomy: the answer (not the
    request) would be wrong or meaningless."""


class InvalidInputError(NumericalError, ValueError):
    """Malformed system at the front door: non-finite entries in A or
    b, dimension mismatch, or an empty system."""


class StructurallySingularError(NumericalError, ValueError):
    """The sparsity pattern itself is singular (empty row/column): no
    value assignment makes the matrix invertible.  Carries the first
    offending indices.  Subclasses ValueError: before this type
    existed, the same inputs died as the equilibration ValueError
    (zero row max), and callers catching that keep working."""

    def __init__(self, msg: str, *, empty_rows=(), empty_cols=()):
        super().__init__(msg)
        self.empty_rows = tuple(int(i) for i in empty_rows)
        self.empty_cols = tuple(int(i) for i in empty_cols)


class SingularMatrixError(NumericalError):
    """Numerically singular (or refused as too ill-conditioned) at
    factor time: the estimated rcond fell below the policy floor.
    Carries the estimate so callers can log the margin."""

    def __init__(self, msg: str, *, rcond: float | None = None):
        super().__init__(msg)
        self.rcond = rcond
