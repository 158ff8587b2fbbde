"""Where the time goes: one gssvx on the card under torch.profiler.

    python -m superlu_dist_tpu_torch.profile [--k 48] [--dtype float64]

Runs gssvx on laplacian_3d(k) once to warm up (kernel builds, the host
library, caches), then once more under torch.profiler with CPU and
CUDA activities, then once more unprofiled for the phase walls (under
cProfile with --host).  Prints one JSON object: the card, the phase walls of
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
    ("K1 panel_lu", ("diag_factor_kernel", "panel_trsm_kernel",
                     "schur_kernel")),
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


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=48)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--host", action="store_true",
                    help="also profile the host side (cProfile) of the "
                         "unprofiled run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils import testmat
    a = testmat.laplacian_3d(args.k)
    xtrue = np.random.default_rng(0).standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    opts = st.Options(factor_dtype=args.dtype)
    st.gssvx(opts, a, b)                       # warm-up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x, lu, stats = st.gssvx(opts, a, b)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a second, unprofiled run for the phase walls without tracing
    # cost, under cProfile when asked: host time by Python function
    host = None
    if args.host:
        import cProfile
        import io
        import pstats
        pr = cProfile.Profile()
        pr.enable()
    _, _, stats2 = st.gssvx(opts, a, b)
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
