"""Typed numerical-failure taxonomy (numerics/errors.py)."""

from .errors import (InvalidInputError, NumericalError,  # noqa: F401
                     StructurallySingularError)
