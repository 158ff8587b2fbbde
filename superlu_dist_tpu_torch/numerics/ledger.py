"""Perturbation ledger: tiny-pivot replacements as first-class data.

GESP replaces a pivot whose magnitude falls below sqrt(eps)·‖A‖ with
sign(piv)·sqrt(eps)·‖A‖ (ops/batched.py `_thresh_for`; K1 does it on
the card and counts it).  The ledger makes each factorization's
perturbation auditable: how many pivots, WHERE (original column
indices), and the total magnitude injected — the data a caller needs
to decide whether a solve through these factors is trustworthy, and
the payload stamped onto results (`PerturbedResult`).

Location recovery is post hoc and free on the happy path: replaced
pivots sit at EXACTLY ±thresh in diag(U), so when K1's counter says
count > 0 one O(n) diagonal gather (models/gssvx.get_diag_u — only n
scalars cross to the host) finds them; a clean factorization
(count == 0) never pays the gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import dtype_info

# stamped payloads ride result stamps and health records; cap the
# per-factorization location list so a pathological matrix (every
# pivot tiny) cannot bloat every downstream record
_MAX_LOCATIONS = 32


@dataclasses.dataclass(frozen=True)
class PerturbationLedger:
    """One factorization's tiny-pivot replacement record."""
    count: int                       # pivots replaced
    threshold: float                 # replacement magnitude sqrt(eps)*anorm
    locations: tuple = ()            # original column indices (capped)
    truncated: bool = False          # locations hit _MAX_LOCATIONS
    total_magnitude: float = 0.0     # sum |new pivot| over replacements

    @property
    def perturbed(self) -> bool:
        return self.count > 0

    def to_dict(self) -> dict:
        return {"count": int(self.count),
                "threshold": float(self.threshold),
                "locations": [int(i) for i in self.locations],
                "truncated": bool(self.truncated),
                "total_magnitude": float(self.total_magnitude)}


class PerturbedResult(np.ndarray):
    """Marker subclass stamped on solutions that rode PERTURBED or
    ill-conditioned factors: GESP replaced tiny pivots during the
    factorization (the `ledger` attribute carries this module's record)
    and/or the estimated rcond classified the key ill-conditioned under
    SLU_COND_POLICY=stamp (`rcond` attribute).  Numerically a normal
    ndarray — the stamp is the honesty, not a different number;
    `np.asarray(x)` strips it."""

    ledger = None       # PerturbationLedger | None
    rcond = None        # float | None

    def __array_finalize__(self, obj):
        # slices and views inherit the stamp: each column of a
        # many-right-hand-side solve carries the ledger it rode
        if obj is None:
            return
        self.ledger = getattr(obj, "ledger", None)
        self.rcond = getattr(obj, "rcond", None)


def stamp_perturbed(x: np.ndarray, ledger=None,
                    rcond=None) -> PerturbedResult:
    """View-stamp a solution as perturbed/ill-conditioned (zero-copy)."""
    out = np.asarray(x).view(PerturbedResult)
    out.ledger = ledger
    out.rcond = rcond
    return out


def strip_result_markers(x):
    """Plain base-class view of a possibly stamped array; anything that
    is not an ndarray subclass (tensors, lists) passes through
    untouched.  A boundary that hands the solution to other code (the
    autodiff layer, item 13) strips here so a stale ledger never rides
    an array it does not describe."""
    if isinstance(x, np.ndarray) and type(x) is not np.ndarray:
        return x.view(np.ndarray)
    return x


def build_ledger(lu) -> PerturbationLedger:
    """Ledger for a live factorization handle.  Reads the tiny-pivot
    count (K1's on the device, the host backend's own on the host);
    only when it is nonzero does the O(n) diagonal gather run to
    recover locations."""
    from ..models.gssvx import get_diag_u
    from ..ops.batched import _thresh_for
    src = lu.host_lu if lu.backend == "host" else lu.device_lu
    count = int(src.tiny_pivots)
    fdt = dtype_info(lu.effective_options.factor_dtype)
    thresh = float(_thresh_for(lu.plan, fdt))
    if count == 0 or thresh == 0.0:
        return PerturbationLedger(count=count, threshold=thresh)
    diag = get_diag_u(lu)
    # replaced pivots are EXACTLY ±thresh in the factor dtype; compare
    # against thresh rounded through that dtype with a few ulps of slack
    tol = 16.0 * fdt.eps
    t_cast = abs(float(torch.tensor(thresh, dtype=fdt.torch).real))
    mag = np.abs(np.asarray(diag, dtype=np.float64))
    # diag is in factor column order; diag[final_col[j]] is original
    # column j's pivot — reindex so locations are caller-meaningful
    hit = np.flatnonzero(np.abs(mag[lu.plan.final_col] - t_cast)
                         <= tol * max(t_cast, 1.0))
    locs = tuple(int(i) for i in hit[:_MAX_LOCATIONS])
    return PerturbationLedger(
        count=count, threshold=thresh, locations=locs,
        truncated=len(hit) > _MAX_LOCATIONS,
        total_magnitude=count * thresh)
