"""Where the time goes: one gssvx on the card under torch.profiler.

    python -m superlu_dist_tpu_torch.profile [--k 48] [--dtype float64]

Runs gssvx on laplacian_3d(k) once to warm up (kernel builds, the host
library, caches, the captured CUDA graphs of the factor and solve
programs), then refactors the same values on the same plan
(Fact.SAME_PATTERN_SAME_ROWPERM, which replays those graphs) once more
under torch.profiler with CPU and CUDA activities, then once more
unprofiled for the phase walls (under cProfile with --host).  Prints one JSON object: the card, the phase walls of
the unprofiled run (host clock; the numeric phases end in a device
synchronisation), the device-busy time of the profiled run (sum of
kernel times, one stream), two idle shares — of the profiled window,
which tracing inflates, and of the unprofiled run's summed phase walls
(the same work, untraced) — and kernel time by
category — the port's three kernels, the library GEMMs (triangular
inverses, solve products), and the PyTorch copy/index/elementwise
kernels — plus the top kernels by device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

CATEGORIES = (
    ("K1 small", ("lu_small",)),
    ("K1 panel", ("panel_step", "panel_copy", "strip_solve")),
    ("K1 update", ("schur_update",)),
    ("K2 ea_scatter", ("ea_narrow", "ea_wide")),
    ("K3 lsum", ("lsum_fused", "row_dots", "tile_product")),
    ("gemm (library)", ("gemm", "gemv", "cutlass", "sm90_xmma",
                        "sm80_xmma", "ampere", "Kernel2")),
    ("index/scatter", ("index", "scatter", "gather")),
    ("copy/fill", ("copy", "fill", "memcpy", "memset", "cat")),
)


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other elementwise"


# H100 SXM published peaks (NVIDIA data sheet), as chip_smoke.py uses
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12        # float64 tensor cores; float32 without them


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def kernel_bounds(lu, itemsize: int, lsum_calls: int) -> dict:
    """Least device ms of the run's K1, K2 and K3 work: each call's
    larger of operations over the peak and bytes over HBM's rate,
    summed over the schedule.  K1 both ways: padded (the fronts the
    kernel is handed, panel_lu.k1_flops / k1_bytes per group) and true
    (the plan's flop counts of the live fronts, over the peak alone).
    K3 at one right-hand side, `lsum_calls` calls spread evenly over the
    schedule's groups (one forward sweep per solve)."""
    import torch
    from .ops import ea_scatter, lsum, panel_lu, trisolve
    sched = lu.device_lu.schedule
    dev = torch.device("cuda", torch.cuda.current_device())
    k1 = sum(_bound_ms(panel_lu.k1_flops(g.n_loc, g.mb, g.wb),
                       panel_lu.k1_bytes(g.n_loc, g.mb, itemsize))
             for g in sched.groups)
    k2 = 0.0
    for g in sched.groups:
        for b in g.dev(dev).ea:
            live, nbytes = ea_scatter.bound_work(b, g.mb, itemsize)
            k2 += _bound_ms(live, nbytes)
    ts = trisolve.get_trisolve(sched)
    sweep = sum(_bound_ms(*lsum.bound_work(gs.trim, g.wb, gs.rtrim, 1,
                                           itemsize, itemsize))
                for g, gs in zip(sched.groups, ts.groups))
    plan = lu.plan
    return {
        "K1_padded_ms": k1,
        "K1_true_ms": plan.true_factor_flops / PEAK_FLOPS * 1e3,
        "K1_plan_factor_flops_ms": plan.factor_flops / PEAK_FLOPS * 1e3,
        "K2_ms": k2,
        "K3_ms": sweep * lsum_calls / max(1, len(sched.groups)),
    }


def k1_kernels(N: int, mb: int, wb: int, dtype: str, calls: int = 5):
    """K1 at one group shape under torch.profiler: device ms per call
    of each CUDA kernel it runs (mean over `calls` calls on a
    diagonally dominant random batch, reset between calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .ops import panel_lu
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(mb + wb)
    F0 = torch.randn(N, mb, mb, generator=g, dtype=tdt, device="cuda")
    F0 += mb * torch.eye(mb, dtype=tdt, device="cuda")
    F = F0.clone()
    thresh = 1e-8 * float(F0.abs().max())
    panel_lu.partial_lu_batch(F, thresh, wb=wb)     # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            F.copy_(F0)
            panel_lu.partial_lu_batch(F, thresh, wb=wb)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev = float(getattr(ev, "self_device_time_total", 0.0))
        if dev > 0 and not ev.key.startswith("aten::"):
            out[ev.key[:80]] = {"ms_per_call": dev / 1e3 / calls,
                                "launches_per_call": ev.count / calls}
    return {"shape": [N, mb, wb], "dtype": dtype,
            "plan": panel_lu.launch_plan(N, mb, wb, tdt).regime,
            "kernels": out}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=48)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--k1", action="append", metavar="N,mb,wb",
                    help="instead: K1 alone at this group shape (may be "
                         "repeated), device ms per call of each of its "
                         "CUDA kernels")
    ap.add_argument("--host", action="store_true",
                    help="also profile the host side (cProfile) of the "
                         "unprofiled run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    if args.k1:
        print(json.dumps([k1_kernels(*(int(v) for v in s.split(",")),
                                     args.dtype) for s in args.k1],
                         indent=1))
        return 0
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils import testmat
    a = testmat.laplacian_3d(args.k)
    xtrue = np.random.default_rng(0).standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    _, lu0, _ = st.gssvx(st.Options(factor_dtype=args.dtype), a,
                         b)                    # warm-up, captures
    opts = st.Options(factor_dtype=args.dtype,
                      fact=st.Fact.SAME_PATTERN_SAME_ROWPERM)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x, lu, stats = st.gssvx(opts, a, b, lu=lu0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a second, unprofiled run for the phase walls without tracing
    # cost, under cProfile when asked: host time by Python function
    from .ops import lsum
    host = None
    if args.host:
        import cProfile
        import io
        import pstats
        pr = cProfile.Profile()
        pr.enable()
    lsum.lsum_panel.launches = 0
    _, _, stats2 = st.gssvx(opts, a, b, lu=lu0)
    lsum_calls = lsum.lsum_panel.launches
    if args.host:
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(
            args.top * 2)
        host = buf.getvalue().splitlines()
    cats: dict = {}
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        dev = float(getattr(ev, "self_device_time_total", 0.0))
        if dev <= 0 or ev.key.startswith("aten::"):
            continue
        busy_us += dev
        c = _category(ev.key)
        ent = cats.setdefault(c, {"device_ms": 0.0, "launches": 0})
        ent["device_ms"] += dev / 1e3
        ent["launches"] += int(ev.count)
        rows.append((dev / 1e3, int(ev.count), ev.key[:120]))
    rows.sort(reverse=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    u = stats2.utime
    out = {
        "card": card, "k": args.k, "n": int(a.n),
        "factor_dtype": args.dtype,
        "relerr": float(np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue)),
        "berr": float(stats.berr),
        "phase_s_unprofiled": {p: u[p] for p in u if u[p]},
        "profiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "idle_share": (max(0.0, 1.0 - busy_us / 1e6 / wall)
                       if busy_us else None),
        "idle_share_phase_walls": (
            max(0.0, 1.0 - busy_us / 1e6 / sum(u.values()))
            if busy_us else None),
        "by_category": {k: {"device_ms": round(v["device_ms"], 3),
                            "launches": v["launches"]}
                        for k, v in sorted(cats.items(),
                                           key=lambda kv:
                                           -kv[1]["device_ms"])},
        "bounds": kernel_bounds(
            lu, 8 if args.dtype == "float64" else 4, lsum_calls),
        "top_kernels": [{"device_ms": round(ms, 3), "count": n,
                         "name": name}
                        for ms, n, name in rows[:args.top]],
    }
    if host is not None:
        out["host_cprofile"] = host
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
