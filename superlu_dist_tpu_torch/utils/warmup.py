"""Capture the staged factor graphs of a schedule ahead of its first
factorization.

The reference compiles every distinct staged program of a plan ahead
of time, in parallel, so that a first factorization only dispatches.
Here a staged program is a CUDA graph, and capturing one records its
launches without running them, so `warmup_staged` captures every
factor segment graph of the plan's schedule on the card before any
values exist; the first factorization then only replays.  Capture runs
Python and is sequential: there is nothing to parallelise.

The solve graphs read the panels of one factorization, so they belong
to its handle and are captured per handle (models/gssvx.warm_solve).

Usage:
    plan = plan_factorization(a, opts)
    report = warmup_staged(plan, dtype="float64")
    # ... factorize/solve as usual: the factor sweep only replays
"""

from __future__ import annotations

import time
import warnings



def staged_signatures(sched, dtype="float64"):
    """(factor_sigs, sweep_sigs): the staged factor graph keys of the
    schedule for `dtype` ((members, metas) per merged segment, the
    `factor_seg_metas` definition shared with the dispatch site), and
    the solve segment keys ((members, seg_metas) per forward segment),
    each mapped to its segment index.  A graph bakes in its operands'
    addresses, so every segment is a graph of its own: unlike the
    reference's program keys, two segments of equal shapes do not share
    one."""
    from ..ops import batched as B
    from ..ops import trisolve as T
    fsigs = {B.factor_graph_key(sched, seg, dtype): i
             for i, seg in enumerate(B.get_factor_segments(sched))}
    ts = T.get_trisolve(sched)
    ssigs = {(tuple(seg), T.seg_metas(ts, seg)): i
             for i, seg in enumerate(ts.segments)}
    return fsigs, ssigs


def warmup_staged(plan, dtype="float64", device=None,
                  force: bool = False) -> dict:
    """Capture every staged factor segment graph of `plan` for the
    factor `dtype` on the card.  Returns {"factor_programs" (segments),
    "captured" (graphs captured now), "secs"}; on the CPU, where the
    bodies run eagerly, nothing is captured."""
    from ..device import resolve_device
    from ..ops import batched as B
    from ..ops import graphs
    sched = B.get_schedule(plan)
    dev = resolve_device(device if device is not None else plan.device)
    nseg = len(B.get_factor_segments(sched))
    if not force and not B.staged_enabled(sched):
        # the factorization would take the whole-phase arm
        warnings.warn(
            "warmup_staged: staged execution is inactive for this "
            f"schedule ({len(sched.groups)} groups; see SLU_STAGED) — "
            "nothing to warm.  Pass force=True to capture anyway.",
            stacklevel=2)
        return {"factor_programs": 0, "captured": 0, "secs": 0.0,
                "staged_inactive": True}
    t0 = time.perf_counter()
    n = (B.capture_staged(plan, dtype, dev)
         if graphs.on_card(dev) else 0)
    return {"factor_programs": nseg, "captured": n,
            "secs": time.perf_counter() - t0}
