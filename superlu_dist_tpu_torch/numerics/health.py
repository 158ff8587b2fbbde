"""The numerical-health seam: the pivot-growth probe and the one hook
where the reference records an `obs.HEALTH` event.

The reference keeps a process-wide health monitor (obs/health.py); the
port's observability layer is ROADMAP queue 1 item 14.  Until it lands,
`record` is the single place every such event passes through — factor
(tiny pivots, perturbation), rcond, escalation, pivot growth
unavailable — and it records nothing: no process-wide state changes.
"""

from __future__ import annotations

import numpy as np


def record(event: str, **fields) -> None:
    """Where the reference calls `obs.HEALTH.record_<event>(**fields)`.
    Records nothing until item 14 gives it a monitor."""


def pivot_growth(lu) -> float | None:
    """Cheap pivot-growth estimate for a GESP factorization:
    max|diag(U)| / ‖A_scaled‖ (diagonal only — a lower bound on the
    classic max|U|/max|A|, one O(n) gather and no factor transfer).
    Compare against 1/eps of the factor dtype.  Returns None instead of
    raising when the factors cannot be probed (this runs on the
    factorize path), and records a `pivot_growth_unavailable` event."""
    try:
        from ..models.gssvx import get_diag_u
        du = np.abs(np.asarray(get_diag_u(lu)))
        anorm = float(getattr(lu.plan, "anorm", 0.0)) or 1.0
        return float(du.max() / anorm) if du.size else 0.0
    except Exception:   # noqa: BLE001 — a probe never throws into factorize
        record("pivot_growth_unavailable",
               dtype=str(getattr(getattr(lu, "effective_options", None),
                                 "factor_dtype", "")))
        return None
