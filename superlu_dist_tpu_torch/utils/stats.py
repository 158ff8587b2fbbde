"""Execution statistics and per-phase timing.

Analog of SuperLUStat_t (SRC/util_dist.h:101-123), the PhaseType keys
(SRC/superlu_enum_consts.h:66-90) and PStatPrint (SRC/util.c:331).  A
phase timer measures host wall time; the numeric phases synchronise
the device before they return, so device work lands in the phase that
launched it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict

# Phase keys mirroring PhaseType (SRC/superlu_enum_consts.h:66-90).
# FACT_ESC is the precision-escalation rerun (a second factorization at
# refine precision), reported apart so FACT's GFLOP/s never blends two
# differently-precisioned runs.
PHASES = (
    "EQUIL", "ROWPERM", "COLPERM", "ETREE", "SYMBFACT", "DIST",
    "SCHED", "FACT", "FACT_ESC", "SOLVE", "REFINE",
)


@dataclasses.dataclass
class Stats:
    utime: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {p: 0.0 for p in PHASES})
    ops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {p: 0.0 for p in PHASES})
    tiny_pivots: int = 0
    refine_steps: int = 0
    berr: float = 0.0
    # last refinement loop quit on a genuine stall (berr stopped
    # halving short of eps — models/refine.py)
    refine_stalled: bool = False
    # precision escalations: a low-precision factor failed refinement
    # and was refactored one rung up (models/gssvx.py)
    escalations: int = 0
    lu_nnz: int = 0
    lu_bytes: int = 0
    # one {tiny_pivots, dtype} record per factorize() under this Stats
    factor_events: list = dataclasses.field(default_factory=list)
    # condition estimate of the LAST factorization served through this
    # run (numerics/gscon.ensure_rcond), None when not estimated
    rcond: float | None = None

    @contextlib.contextmanager
    def timer(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.utime[phase] = self.utime.get(phase, 0.0) + (
                time.perf_counter() - t0)

    def add_ops(self, phase: str, flops: float) -> None:
        self.ops[phase] = self.ops.get(phase, 0.0) + flops

    def note_factor_event(self, *, tiny_pivots: int = 0,
                          dtype: str = "") -> None:
        self.factor_events.append({"tiny_pivots": int(tiny_pivots),
                                   "dtype": str(dtype)})

    def gflops(self, phase: str) -> float:
        t = self.utime.get(phase, 0.0)
        if t <= 0:
            return 0.0
        return self.ops.get(phase, 0.0) / t / 1e9

    def report(self) -> str:
        """PStatPrint-style report (SRC/util.c:331)."""
        lines = ["** Phase breakdown **"]
        for p in PHASES:
            t = self.utime.get(p, 0.0)
            if t == 0.0 and self.ops.get(p, 0.0) == 0.0:
                continue
            line = f"  {p:<10s} {t * 1e3:10.2f} ms"
            if self.ops.get(p, 0.0) > 0:
                line += f"  {self.gflops(p):8.2f} GF/s"
            lines.append(line)
        lines.append(f"  tiny pivots replaced: {self.tiny_pivots}")
        lines.append(f"  refinement steps:     {self.refine_steps}")
        if self.rcond is not None:
            lines.append(f"  estimated rcond:      {self.rcond:.2e}")
        lines.append(f"  backward error:       {self.berr:.3e}")
        if self.escalations:
            lines.append(f"  precision escalations: {self.escalations}")
        if self.lu_nnz:
            lines.append(
                f"  nnz(L+U): {self.lu_nnz}  LU bytes: {self.lu_bytes}")
        return "\n".join(lines)
