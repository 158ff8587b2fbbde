#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --parent-k1 OLD/panel_lu.cu   # K1 also
                                     # timed against an earlier K1 source

Phases, each of which raises (non-zero exit) on failure:
  1. card      — name, power limit, torch and CUDA versions;
  2. build     — K1–K3 (superlu_dist_tpu_torch/csrc/*.cu) with nvcc for
                 sm_90a, one nvcc per source, all started together;
  3. kernels   — each kernel against its plain PyTorch version on the
                 card, float32 and float64, at shapes taken from the
                 k=48 schedule (its most frequent bucket and its
                 largest), timed beside the plain version, one PyTorch
                 library call where one computes the same function, and
                 the bound (bytes over 3.35 TB/s or flops over 67
                 TFLOP/s, whichever is larger).  Every kernel is timed
                 in turns with its plain version and library call, as
                 device time (CUDA-graph replays); K1 works in place, so
                 each of its calls is replayed after a reset copy and
                 the copy alone, timed in the same turns, is subtracted.
                 K1 also runs at a middle shape of the k=48 schedule,
                 beside one `torch.baddbmm` of its trailing update
                 (`update_library_ms`: no one call computes all of K1),
                 and alone at every distinct shape of the schedule
                 (`k1_sweep` in the JSON, with launches and bounds); the
                 `[vs library]` line gives ms / library ms and bound
                 ms / ms;
  4. main path — gssvx(Options(), a, b) on laplacian_3d(48) in float64,
                 with every kernel launch count set to 0 just before and
                 read just after (each must be > 0); berr ≤ 64·eps(f64);
     refactor  — new values (seeded) on the same pattern refactored on
                 the same plan (SAME_PATTERN_SAME_ROWPERM): the factor
                 graphs replay, none is captured;
  5. mixed     — the same matrix refactored in float32 (solve_dtype
                 float32, float64 refinement), converging without
                 escalation;
  6. fused     — refinement on the device: make_fused_solver on
                 laplacian_3d(48) with a float32 factor and float64
                 refinement (bench.py's configuration, the staged arm),
                 on the same matrix in float64, and (after phase 7's
                 drive) on convection_diffusion_2d(200) in float64 (the
                 whole-phase arm), vals and b already on the card, at
                 nrhs 1 and 64: the first (capturing) call and the median
                 of three later ones as host walls, the graphs each call
                 captured (0 after the first), steps, berr ≤ 64·eps(f64),
                 the K1–K3 launches of each call (each > 0), resident and
                 peak device memory, and in the same turns gssvx
                 refactoring the same values with its host refinement
                 (its REFINE wall); one ELL residual matvec of
                 laplacian_3d(48) at nrhs 1 and 64 against its bound and
                 a torch.sparse CSR product;
  7. unsym     — convection_diffusion_2d(200) in float64 (59 groups: the
                 whole-phase arm, one graph for the factor sweep);
  8. graphs    — the compiled-program layer (ops/graphs.py) on both
                 arms: laplacian_3d(48) float64 (staged, one graph per
                 merged segment) and convection_diffusion_2d(200)
                 (whole phase).  The first, capturing factorization;
                 then the eager loop and graph replays in turns (FACT
                 host walls, the slabs held bit for bit equal); the
                 copy-out of the slabs (device time); one FACTORED solve
                 at nrhs 1 and 64, eager against replay (host walls, and
                 the sweeps' device span without the host transfers);
                 device busy and idle share of a replayed factorization
                 and solve under torch.profiler; peak device memory,
                 eager against graphs; graphs and segments;
  9. the kernels line, the card line, and the contract line last.
Everything is made from fixed seeds.  Details go to
chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67
# TFLOP/s float32 outside the tensor cores and 67 TFLOP/s float64 on
# the tensor cores (the larger float64 rate, so the bound stays a
# lower bound)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# kernel vs plain version, max |diff| / max |plain|: rounding order
# differs (substitution vs Newton inverses, atomics vs ordered adds)
TOL = {"float32": 1e-4, "float64": 1e-10}
BERR_MAX = 64 * 2.220446049250313e-16


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_cuda(fn, reps=5, setup=None):
    """Median milliseconds of `fn` over `reps` runs, CUDA events around
    each run; `setup` (untimed) runs before each."""
    import torch
    if setup is not None:
        setup()
    fn()                                    # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def time_turns(fns: dict, eager=(), rounds=7, inner=10):
    """Median device milliseconds per call of each function in `fns`,
    timed in turns on the same card.  Each function's `inner` calls are
    captured once into a CUDA graph (those named in `eager`, which
    synchronise with the host, run eagerly instead), so the times are
    the device's and not the host's launch overhead.  Each round replays
    every function once between CUDA events, in forward order on even
    rounds and reverse order on odd ones, so drifts of clock and power
    fall on all of them alike."""
    import torch
    runs = {}
    for k, fn in fns.items():
        fn()                                # warm-up (and first build)
        torch.cuda.synchronize()
        if k in eager:
            runs[k] = lambda fn=fn: [fn() for _ in range(inner)]
            continue
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        runs[k] = g.replay
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            runs[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e) / inner)
    return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(flops: float, nbytes: float, dtype: str):
    tf = flops / PEAK_FLOPS[dtype]
    tb = nbytes / HBM_BYTES_PER_S
    return max(tf, tb) * 1e3, ("operations" if tf > tb else "bytes")


def rel_err(a, b) -> tuple:
    d = float((a - b).abs().max())
    s = float(b.abs().max()) or 1.0
    return d, d / s


# --------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------

def counters():
    from superlu_dist_tpu_torch.ops import ea_scatter, lsum, panel_lu
    return {"panel_lu": panel_lu.partial_lu_batch,
            "ea_scatter": ea_scatter.ea_scatter_add,
            "lsum": lsum.lsum_panel}


def drive(label, options, a, lu=None, seed=0):
    """One gssvx call through the user entry point, with the kernel
    launch counts set to 0 just before it and read just after."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    xtrue = np.random.default_rng(seed).standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    cs = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in cs.values():
        f.launches = 0
    t0 = time.perf_counter()
    x, lu, stats = st.gssvx(options, a, b, lu=lu)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in cs.items()}
    relerr = float(np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue))
    u = stats.utime
    rec = {
        "label": label, "n": int(a.n), "nnz": int(a.nnz),
        "factor_dtype": options.factor_dtype,
        "wall_s": wall,
        "plan_s": sum(u[p] for p in ("EQUIL", "ROWPERM", "COLPERM",
                                     "ETREE", "SYMBFACT", "DIST")),
        "sched_s": u["SCHED"],
        "factor_s": u["FACT"] + u["FACT_ESC"],
        "solve_s": u["SOLVE"], "refine_s": u["REFINE"],
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "berr": float(stats.berr), "relerr": relerr,
        "refine_steps": stats.refine_steps,
        "escalations": stats.escalations,
        "tiny_pivots": stats.tiny_pivots,
        "factor_flops": float(lu.plan.factor_flops),
        "groups": len(lu.device_lu.schedule.groups),
        "launches": launches,
    }
    log(f"[{label}] " + json.dumps(rec))
    if not np.all(np.isfinite(x)) or x.shape != (a.n,):
        raise RuntimeError(f"{label}: bad solution")
    if not stats.berr <= BERR_MAX:
        raise RuntimeError(f"{label}: berr {stats.berr} > {BERR_MAX}")
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"{label}: kernel {k} was never launched")
    return lu, rec


# --------------------------------------------------------------------
# the compiled-program layer: eager loop against CUDA-graph replays
# --------------------------------------------------------------------

def _synced(fn):
    """Host wall seconds of fn() ending in a device synchronisation."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _busy(fn):
    """(device busy ms, host wall ms) of fn() under torch.profiler:
    the summed device time of its kernels, one stream, over the wall
    of the same run; None for busy when the trace shows no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                    # warm, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _synced(fn)
    busy = sum(float(getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages()
               if not e.key.startswith("aten::")) / 1e3
    return (busy or None), wall * 1e3


def graph_phase(label, a, rounds=3):
    """The compiled-program layer on one matrix (see the module
    docstring, phase 8); raises when a replay differs from the eager
    loop beyond bitwise equality of the slabs or TOL of a solution."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched, graphs, trisolve
    dev = torch.device("cuda", torch.cuda.current_device())
    plan = st.plan_factorization(a)
    vals = plan.scaled_values(a)
    sched = batched.get_schedule(plan)
    sched.to_device(dev)
    staged = batched.staged_enabled(sched)

    def fact(eager):
        return batched.factorize_device(plan, vals, np.float64, dev,
                                        eager=eager)

    fact(True)                              # warm the eager path
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first_s, lu = _synced(lambda: fact(False))
    first_peak = torch.cuda.max_memory_allocated() - base
    held_by_graphs = torch.cuda.memory_allocated() - base
    n_graphs = graphs.graph_count(sched)
    walls = {"eager": [], "graph": []}
    for r in range(rounds):
        for eager in ((True, False) if r % 2 == 0 else (False, True)):
            w, lu_r = _synced(lambda: fact(eager))
            walls["eager" if eager else "graph"].append(w)
            if eager:
                ref = lu_r
            del lu_r
    if graphs.graph_count(sched) != n_graphs:
        raise RuntimeError(f"{label}: a replaying factorization captured")
    for x, y in zip(lu.flats(), ref.flats()):
        if not torch.equal(x, y):
            raise RuntimeError(f"{label}: replayed slabs differ from the "
                               "eager loop's")
    copy_ms = time_cuda(lambda: [f.clone() for f in lu.flats()])
    held = sum(f.numel() * f.element_size() for f in lu.flats())
    rng = np.random.default_rng(7)
    solve = {}
    for R in (1, 64):
        b = rng.standard_normal((plan.n, R))
        x_ref = batched.solve_device(ref, b, eager=True)
        x_g = batched.solve_device(lu, b)            # captures
        _, rel = rel_err(torch.from_numpy(x_g), torch.from_numpy(x_ref))
        if not rel <= TOL["float64"]:
            raise RuntimeError(f"{label}: replayed solve nrhs {R} rel err "
                               f"{rel:.3e}")
        sw = {"eager": [], "graph": []}
        for r in range(rounds):
            for eager in ((True, False) if r % 2 == 0 else (False, True)):
                w, _ = _synced(lambda: batched.solve_device(
                    ref if eager else lu, b, eager=eager))
                sw["eager" if eager else "graph"].append(w)
        solve[R] = {k: statistics.median(v) for k, v in sw.items()}
        solve[R]["rel_err"] = rel
        # the sweeps alone, right-hand side already on the card: the
        # device span between CUDA events (host transfers excluded)
        sweeps = (trisolve.staged_sweeps if staged
                  else trisolve.solve_packed)
        bd = torch.from_numpy(b).to(dev)
        for eager in (True, False):
            solve[R][("eager" if eager else "graph") + "_span_ms"] = \
                time_cuda(lambda: sweeps(ref if eager else lu, bd, False,
                                         eager=eager))
    # peak device memory of one factorization and the first solve of
    # its handle (which captures that handle's solve graphs), each way
    peaks = {}
    b1 = rng.standard_normal(plan.n)
    for eager in (True, False):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lu_m = fact(eager)
        batched.solve_device(lu_m, b1, eager=eager)
        torch.cuda.synchronize()
        peaks["eager" if eager else "graph"] = (
            torch.cuda.max_memory_allocated() - m0)
        del lu_m
    # device busy over one factorization and one FACTORED solve (on a
    # handle whose solve graphs exist), each way
    busy = {}
    for eager in (True, False):
        held_lu = ref if eager else lu
        busy["eager" if eager else "graph"] = _busy(
            lambda: (fact(eager), batched.solve_device(held_lu, b1,
                                                       eager=eager)))
    ts = trisolve.get_trisolve(sched)
    rec = {
        "label": label, "arm": "staged" if staged else "whole phase",
        "groups": len(sched.groups),
        "factor_segments": (len(batched.get_factor_segments(sched))
                            if staged else 1),
        "solve_segments": len(ts.segments) if staged else 1,
        "factor_graphs": n_graphs,
        "solve_graphs_per_key": (2 * len(ts.segments) + 1 if staged
                                 else 1),
        "first_fact_s": first_s,
        "fact_s": {k: statistics.median(v) for k, v in walls.items()},
        "fact_s_all": walls,
        "copy_out_ms": copy_ms, "held_bytes": held,
        "solve_s": solve,
        "first_fact_peak_bytes": first_peak,
        "graph_static_bytes": held_by_graphs,
        "peak_bytes": peaks,
        "busy_ms_wall_ms": busy,
        "idle_share": {k: (1 - b / w if b else None)
                       for k, (b, w) in busy.items()},
    }
    log(f"[graphs {label}] " + json.dumps(rec))
    return rec


# --------------------------------------------------------------------
# refinement on the device: the fused solver and its residual SpMV
# --------------------------------------------------------------------

def spmv_timing(a, dev):
    """One ELL `matvec` of `a` (float64) at nrhs 1 and 64, device time
    against its bound and against `torch.sparse` CSR products (the
    library reference, eager: cuSPARSE is not captured)."""
    import numpy as np
    import torch
    from superlu_dist_tpu_torch.ops.spmv import DeviceSpMV
    m = DeviceSpMV.build(a, device=dev)
    if m.layout != "ell":
        raise RuntimeError(f"auto layout of the residual SpMV is {m.layout}")
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data), size=(a.n, a.n)).to(dev)
    n, w = m.ell_cols.shape
    out = {"n": n, "band": w, "nnz": int(a.nnz),
           "pad_share": 1 - a.nnz / (n * w)}
    for R in (1, 64):
        x = torch.from_numpy(np.random.default_rng(R).standard_normal(
            (n, R))).to(dev)
        xv = x[:, 0].contiguous() if R == 1 else x
        y = m.matvec(xv)
        y_lib = csr @ xv
        torch.cuda.synchronize()
        _, rel = rel_err(y, y_lib)
        if not rel <= TOL["float64"]:
            raise RuntimeError(f"ELL matvec nrhs {R} rel err {rel:.3e}")
        tm = time_turns({"ell": lambda: m.matvec(xv),
                         "library": lambda: csr @ xv}, eager=("library",))
        # each input read once (column and value planes, x), y written
        nbytes = 2 * n * w * 8 + 2 * n * R * 8
        b_ms, b_by = bound_ms(2.0 * a.nnz * R, nbytes, "float64")
        out[f"nrhs{R}"] = {"ms": tm["ell"], "library_ms": tm["library"],
                           "bound_ms": b_ms, "bound_by": b_by,
                           "rel_err": rel}
    log("[spmv] " + json.dumps(out))
    return out


def _launches():
    return {k: f.launches for k, f in counters().items()}


def _zero_launches():
    for f in counters().values():
        f.launches = 0


def fused_phase(label, a, plan, dtype, rounds=3):
    """make_fused_solver on `plan` with a `dtype` factor and float64
    refinement, vals and b already on the card, at nrhs 1 and 64: the
    first call (captures) and the median of `rounds` later calls as
    host walls, the graphs each call captured (0 after the first),
    steps, berr, relerr and the K1–K3 launches of each call (counts set
    to 0 just before it, each > 0); resident and peak device memory;
    and, in the same turns, gssvx refactoring the same values on the
    same plan with its host refinement (SAME_PATTERN_SAME_ROWPERM)."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    step = batched.make_fused_solver(plan, dtype)
    ctx = step.context
    dev = ctx.device
    vals = torch.from_numpy(a.data).to(dev)
    opts = st.Options(fact=st.Fact.SAME_PATTERN_SAME_ROWPERM,
                      factor_dtype=dtype, solve_dtype=dtype)
    lu = st.factorize(a, opts, plan=plan)
    rec = {"label": label, "factor_dtype": dtype, "n": int(a.n),
           "arm": "staged" if ctx.staged else "whole phase",
           "residual_mode": step.residual_mode,
           "spmv_layout": step.spmv_layout, "nrhs": {}}

    def call(b):
        g0 = ctx.graph_count()
        _zero_launches()
        wall, out = _synced(lambda: step(vals, b))
        return wall, out, ctx.graph_count() - g0, _launches()

    def check(out, launches, xtrue, what):
        x, berr = out[0], float(out[1])
        if x.shape != xtrue.shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{label} {what}: bad solution")
        if not berr <= BERR_MAX:
            raise RuntimeError(f"{label} {what}: berr {berr} > {BERR_MAX}")
        if int(out[4]) != 0:
            raise RuntimeError(f"{label} {what}: zero pivots")
        for k, v in launches.items():
            if v <= 0:
                raise RuntimeError(f"{label} {what}: kernel {k} was never "
                                   "launched")
        return float((x - xtrue).abs().max() / xtrue.abs().max())

    for R in (1, 64):
        xtrue_np = np.random.default_rng(20 + R).standard_normal((a.n, R))
        b_np = a.to_scipy() @ xtrue_np
        b = torch.from_numpy(b_np).to(dev)
        xtrue = torch.from_numpy(xtrue_np).to(dev)
        torch.cuda.synchronize()
        m0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        first_s, out, captured, launches = call(b)
        mem = {"peak_bytes": torch.cuda.max_memory_allocated() - m0,
               "resident_bytes": torch.cuda.memory_allocated() - m0,
               "reserved_bytes": torch.cuda.memory_reserved() - r0}
        relerr = check(out, launches, xtrue, "first call")
        r = {"first_s": first_s, "first_captured": captured,
             "first_launches": launches, "memory": mem}
        fused, host, later = [], [], []
        for k in range(rounds):
            for kind in (("fused", "gssvx") if k % 2 == 0
                         else ("gssvx", "fused")):
                if kind == "fused":
                    w, out, captured, launches = call(b)
                    if captured:
                        raise RuntimeError(f"{label}: a later call captured "
                                           f"{captured} graphs")
                    relerr = check(out, launches, xtrue, "later call")
                    fused.append(w)
                    later.append({"steps": int(out[2]),
                                  "berr": float(out[1]),
                                  "launches": launches})
                else:
                    w, (_, _, stats) = _synced(lambda: st.gssvx(
                        opts, a, b_np, lu=lu, stats=st.Stats()))
                    u = stats.utime
                    host.append({"wall_s": w, "factor_s": u["FACT"],
                                 "solve_s": u["SOLVE"],
                                 "refine_s": u["REFINE"],
                                 "refine_steps": stats.refine_steps,
                                 "berr": float(stats.berr)})
        r.update({
            "later_s": statistics.median(fused), "later_s_all": fused,
            "later": later, "relerr": relerr,
            "gssvx_wall_s": statistics.median(h["wall_s"] for h in host),
            "gssvx_refine_s": statistics.median(h["refine_s"]
                                                for h in host),
            "gssvx": host})
        rec["nrhs"][R] = r
    rec["graphs"] = ctx.graph_count()
    log(f"[fused {label}] " + json.dumps(rec))
    return rec


# --------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------

def _tdt(name):
    import torch
    return {"float32": torch.float32, "float64": torch.float64}[name]


def load_parent_k1(path):
    """Build the parent commit's K1 source (`path`, a panel_lu.cu with
    the launcher signature F, N, mb, wb, nb, thresh, tiny, nzero,
    stream) into the port's build directory and return a launcher
    f(F, thresh, wb) for it; None without a path."""
    if not path:
        return None
    import ctypes
    import torch
    from superlu_dist_tpu_torch.ops import _cuda
    from superlu_dist_tpu_torch.utils.native import build_dir
    out = os.path.join(build_dir(), "libslu_parent_panel_lu.so")
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", _cuda._csrc(), "-o", out, path], check=True)
    lib = ctypes.CDLL(out)
    P, I, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    for name in ("slu_panel_lu_f32", "slu_panel_lu_f64"):
        getattr(lib, name).argtypes = [P, I, I, I, I, D, P, P, P]
        getattr(lib, name).restype = ctypes.c_int
    lib.slu_cuda_errstr.argtypes = [ctypes.c_int]
    lib.slu_cuda_errstr.restype = ctypes.c_char_p

    def run(F, thresh, wb):
        N, mb, _ = F.shape
        tiny = torch.zeros(N, dtype=torch.int32, device=F.device)
        nzero = torch.zeros(N, dtype=torch.int32, device=F.device)
        fn = (lib.slu_panel_lu_f64 if F.dtype == torch.float64
              else lib.slu_panel_lu_f32)
        rc = fn(F.data_ptr(), N, mb, wb, min(32, wb), float(thresh),
                tiny.data_ptr(), nzero.data_ptr(), _cuda.stream_ptr(F))
        _cuda.check(lib, rc, "parent panel_lu")
    return run


def k1_bound(N, mb, wb, dtype):
    from superlu_dist_tpu_torch.ops import panel_lu
    it = 8 if dtype == "float64" else 4
    return bound_ms(panel_lu.k1_flops(N, mb, wb),
                    panel_lu.k1_bytes(N, mb, it), dtype)


def time_k1(F0, thresh, wb, fns, rounds=5, inner=5):
    """Device ms per call of each in-place K1 variant in `fns` (name ->
    f(F)), timed in turns by CUDA-graph replays: each variant is (reset
    copy of F0 into its own buffer + the call), and the reset copy alone
    is timed in the same turns and subtracted."""
    bufs = {k: F0.clone() for k in fns}
    runs = {k: (lambda k=k, f=f: (bufs[k].copy_(F0), f(bufs[k])))
            for k, f in fns.items()}
    runs["reset"] = lambda: bufs[next(iter(fns))].copy_(F0)
    tm = time_turns(runs, rounds=rounds, inner=inner)
    return {k: tm[k] - tm["reset"] for k in fns}, tm["reset"]


def check_panel_lu(N, mb, wb, dtype, parent=None):
    import torch
    from superlu_dist_tpu_torch.ops import dense_lu, panel_lu
    tdt = _tdt(dtype)
    g = torch.Generator(device="cuda").manual_seed(N * 7919 + mb)
    F0 = torch.randn(N, mb, mb, generator=g, dtype=tdt, device="cuda")
    F0 += mb * torch.eye(mb, dtype=tdt, device="cuda")
    # plant one exactly-tiny pivot in front 0 (row/col 3 decoupled)
    F0[0, 3, :3] = 0
    F0[0, :3, 3] = 0
    F0[0, 3, 3] = 1e-30
    thresh = float(torch.finfo(tdt).eps) ** 0.5 * float(F0.abs().max())
    F1 = F0.clone()
    F2 = F0.clone()
    _, t1, z1 = panel_lu.partial_lu_batch(F1, thresh, wb=wb)
    _, t2, z2 = dense_lu.partial_lu_batch(F2, thresh, wb=wb)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(F1, F2)
    if int(t1) != int(t2) or int(z1) != int(z2) or int(t1) < 1:
        raise RuntimeError(f"panel_lu counters differ: kernel "
                           f"({int(t1)}, {int(z1)}) plain "
                           f"({int(t2)}, {int(z2)})")
    if not rel <= TOL[dtype]:
        raise RuntimeError(f"panel_lu {dtype} ({N},{mb},{wb}) rel err "
                           f"{rel:.3e} > {TOL[dtype]}")
    del F2
    fns = {"kernel": lambda F: panel_lu.partial_lu_batch(F, thresh, wb=wb),
           "plain": lambda F: dense_lu.partial_lu_batch(F, thresh, wb=wb)}
    if parent is not None:
        fns["parent"] = lambda F: parent(F, thresh, wb)
    tm, reset_ms = time_k1(F0, thresh, wb, fns)
    # the update phase's yardstick: one batched GEMM of the trailing
    # update on the factored operands (not the whole of K1)
    upd_ms = None
    if mb > wb:
        out = torch.empty(N, mb - wb, mb - wb, dtype=tdt, device="cuda")
        L21, U12, F22 = F1[:, wb:, :wb], F1[:, :wb, wb:], F1[:, wb:, wb:]
        upd_ms = time_turns({"baddbmm": lambda: torch.baddbmm(
            F22, L21, U12, alpha=-1, out=out)}, rounds=5, inner=5)[
                "baddbmm"]
        del out
    b_ms, b_by = k1_bound(N, mb, wb, dtype)
    plan = panel_lu.launch_plan(N, mb, wb, tdt)
    return {"shape": [N, mb, wb], "dtype": dtype, "max_abs_err": abs_err,
            "rel_err": rel, "tol": TOL[dtype], "ms": tm["kernel"],
            "plain_ms": tm["plain"], "parent_ms": tm.get("parent"),
            "reset_ms": reset_ms, "library_ms": None,
            "update_library_ms": upd_ms, "bound_ms": b_ms,
            "bound_by": b_by, "regime": plan.regime,
            "kernels_per_call": plan.kernels}


def k1_sweep(sched, parent=None):
    """K1 timed alone (no correctness check) at every distinct (N, mb,
    wb) of the schedule in float64, beside its padded bound and the
    number of groups (wrapper calls) of that shape; the parent's K1 in
    the same turns when given."""
    from collections import Counter
    import torch
    from superlu_dist_tpu_torch.ops import panel_lu
    counts = Counter((g.n_loc, g.mb, g.wb) for g in sched.groups)
    rows = []
    for (N, mb, wb), calls in sorted(counts.items()):
        gen = torch.Generator(device="cuda").manual_seed(mb + wb)
        F0 = torch.randn(N, mb, mb, generator=gen, dtype=torch.float64,
                         device="cuda")
        F0 += mb * torch.eye(mb, dtype=torch.float64, device="cuda")
        thresh = 1e-8 * float(F0.abs().max())
        fns = {"kernel": lambda F, wb=wb: panel_lu.partial_lu_batch(
            F, thresh, wb=wb)}
        if parent is not None:
            fns["parent"] = lambda F, wb=wb: parent(F, thresh, wb)
        tm, _ = time_k1(F0, thresh, wb, fns, rounds=3, inner=3)
        b_ms, b_by = k1_bound(N, mb, wb, "float64")
        plan = panel_lu.launch_plan(N, mb, wb, torch.float64)
        rows.append({"shape": [N, mb, wb], "calls": calls,
                     "regime": plan.regime,
                     "kernels_per_call": plan.kernels,
                     "ms": tm["kernel"], "parent_ms": tm.get("parent"),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "gap_ms": calls * (tm["kernel"] - b_ms)})
        del F0
    rows.sort(key=lambda r: -r["gap_ms"])
    tot = {k: sum(r["calls"] * r[k] for r in rows)
           for k in ("ms", "bound_ms")}
    tot["parent_ms"] = (sum(r["calls"] * r["parent_ms"] for r in rows)
                        if parent is not None else None)
    tot["kernels"] = sum(r["calls"] * r["kernels_per_call"] for r in rows)
    log("[k1 sweep] schedule totals, float64: " + json.dumps(tot))
    return {"rows": rows, "totals": tot}


def check_ea_scatter(sched, g, bucket, dtype):
    import torch
    from superlu_dist_tpu_torch.ops import ea_scatter
    tdt = _tdt(dtype)
    gen = torch.Generator(device="cuda").manual_seed(g.mb + bucket.rc_b)
    F0 = torch.randn(g.n_loc, g.mb, g.mb, generator=gen, dtype=tdt,
                     device="cuda")
    upd = torch.randn(sched.upd_total + sched.upd_pad, generator=gen,
                      dtype=tdt, device="cuda")
    F1 = F0.clone()
    F2 = F0.clone()
    ea_scatter.ea_scatter_add(F1, upd, bucket)
    ea_scatter.ea_scatter_add_plain(F2, upd, bucket)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(F1, F2)
    if not rel <= TOL[dtype]:
        raise RuntimeError(f"ea_scatter {dtype} rc_b={bucket.rc_b} rel "
                           f"err {rel:.3e} > {TOL[dtype]}")
    # the adds accumulate into F1 across the timed calls: the work per
    # call does not depend on the values
    dst, src = ea_scatter.flat_indices(F1, bucket)
    vals = upd[src]
    tm = time_turns({
        "kernel": lambda: ea_scatter.ea_scatter_add(F1, upd, bucket),
        "plain": lambda: ea_scatter.ea_scatter_add_plain(F1, upd, bucket),
        "library": lambda: F1.view(-1).index_add_(0, dst, vals)},
        eager=("plain",))  # its masked gather synchronises
    ms, plain_ms, lib_ms = tm["kernel"], tm["plain"], tm["library"]
    live, nbytes = ea_scatter.bound_work(bucket, g.mb, F0.element_size())
    nrec = int(bucket.so.numel())
    b_ms, b_by = bound_ms(0.0 + live, nbytes, dtype)
    return {"shape": [nrec, bucket.rc_b, g.mb], "dtype": dtype,
            "live_lanes": live, "max_abs_err": abs_err, "rel_err": rel,
            "tol": TOL[dtype],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_lsum(ts, g, gs, R, pdtype, xdtype):
    import torch
    from superlu_dist_tpu_torch.ops import lsum
    tp, tx = _tdt(pdtype), _tdt(xdtype)
    gen = torch.Generator(device="cuda").manual_seed(g.mb * 31 + R)
    t, wb, mb, rt = gs.trim, g.wb, g.mb, gs.rtrim
    Lp = torch.randn(t, mb, wb, generator=gen, dtype=tp,
                     device="cuda") / wb
    Li = torch.randn(t, wb, wb, generator=gen, dtype=tp,
                     device="cuda") / wb
    L21 = Lp[:, wb:, :]
    xb = torch.randn(t, wb, R, generator=gen, dtype=tx, device="cuda")
    bufs = []
    for _ in range(2):
        bufs.append((torch.zeros(ts.y_total + 1, R, dtype=tx,
                                 device="cuda"),
                     torch.zeros(ts.u_total + 1, R, dtype=tx,
                                 device="cuda")))
    (Y1, U1), (Y2, U2) = bufs
    args = (gs.y_off, gs.u_off, rt)
    lsum.lsum_panel(Li, L21, xb, Y1, U1, *args)
    lsum.lsum_panel_plain(Li, L21, xb, Y2, U2, *args)
    torch.cuda.synchronize()
    ey = rel_err(Y1, Y2)
    eu = rel_err(U1, U2)
    abs_err, rel = max(ey[0], eu[0]), max(ey[1], eu[1])
    tol = TOL[pdtype] if pdtype == xdtype else TOL["float64"]
    if not rel <= tol:
        raise RuntimeError(f"lsum {pdtype}/{xdtype} R={R} rel err "
                           f"{rel:.3e} > {tol}")
    L21c = L21[:, :rt, :]

    def two_bmm():
        y = torch.bmm(Li, xb)
        torch.bmm(L21c, y)

    fns = {"kernel": lambda: lsum.lsum_panel(Li, L21, xb, Y1, U1, *args),
           "plain": lambda: lsum.lsum_panel_plain(Li, L21, xb, Y2, U2,
                                                  *args)}
    if pdtype == xdtype:
        fns["library"] = two_bmm
    tm = time_turns(fns)
    ms, plain_ms, lib_ms = tm["kernel"], tm["plain"], tm.get("library")
    flops, nbytes = lsum.bound_work(t, wb, rt, R, Li.element_size(),
                                    xb.element_size())
    b_ms, b_by = bound_ms(flops, nbytes, xdtype)
    return {"shape": [t, wb, rt, R], "dtype": f"{pdtype}/{xdtype}",
            "max_abs_err": abs_err, "rel_err": rel, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "ms_over_plain": ms / plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


def kernel_checks(plan, parent=None):
    from collections import Counter
    import torch
    from superlu_dist_tpu_torch.ops import batched, trisolve
    sched = batched.get_schedule(plan)
    ts = trisolve.get_trisolve(sched)
    res = {"panel_lu": [], "ea_scatter": [], "lsum": []}

    # K1: the most frequent (wb, mb) bucket, the largest group, the
    # group with the most fronts (at k=48 the first two coincide) and a
    # middle group of the k=48 schedule
    freq = Counter((g.wb, g.mb) for g in sched.groups).most_common(1)[0][0]
    g_freq = max((g for g in sched.groups if (g.wb, g.mb) == freq),
                 key=lambda g: g.n_loc)
    g_big = max(sched.groups, key=lambda g: (g.mb, g.n_loc))
    g_many = max(sched.groups, key=lambda g: (g.n_loc, g.mb))
    shapes = list(dict.fromkeys([(g.n_loc, g.mb, g.wb)
                                 for g in (g_freq, g_big, g_many)]
                                + [K1_MIDDLE]))
    for N, mb, wb in shapes:
        for dt in ("float32", "float64"):
            r = check_panel_lu(N, mb, wb, dt, parent)
            log("[kernel panel_lu] " + json.dumps(r))
            res["panel_lu"].append(r)

    # K2: the most frequent element-bucket width and the bucket with
    # the most live lanes
    dev = torch.device("cuda", torch.cuda.current_device())
    buckets = [(g, b) for g in sched.groups for b in g.dev(dev).ea]
    rc_freq = Counter(b.rc_b for _, b in buckets).most_common(1)[0][0]
    pick_f = max(((g, b) for g, b in buckets if b.rc_b == rc_freq),
                 key=lambda gb: gb[1].so.numel())
    pick_b = max(buckets, key=lambda gb: gb[1].so.numel()
                 * gb[1].rc_b ** 2)
    for g, b in (pick_f, pick_b):
        for dt in ("float32", "float64"):
            r = check_ea_scatter(sched, g, b, dt)
            log("[kernel ea_scatter] " + json.dumps(r))
            res["ea_scatter"].append(r)

    # K3: forward groups with update rows — most frequent bucket and
    # the largest — at nrhs 1 and 64, plus the refinement mix
    fwd = [(g, gs) for g, gs in zip(sched.groups, ts.groups)
           if gs.rtrim > 0]
    freq3 = Counter((g.wb, g.mb) for g, _ in fwd).most_common(1)[0][0]
    f_freq = max(((g, gs) for g, gs in fwd if (g.wb, g.mb) == freq3),
                 key=lambda p: p[1].trim)
    f_big = max(fwd, key=lambda p: p[1].trim * p[0].mb * p[0].wb)
    for g, gs in (f_freq, f_big):
        for R in (1, 64):
            for pd, xd in (("float32", "float32"), ("float64", "float64"),
                           ("float32", "float64")):
                r = check_lsum(ts, g, gs, R, pd, xd)
                log("[kernel lsum] " + json.dumps(r))
                res["lsum"].append(r)
    # many right-hand sides are K3's open target: its time over the
    # plain version's at nrhs 64, float64
    log("[lsum nrhs 64] kernel ms / plain ms, float64: " + json.dumps(
        {str(r["shape"]): round(r["ms_over_plain"], 3)
         for r in res["lsum"]
         if r["shape"][-1] == 64 and r["dtype"] == "float64/float64"}))
    # the kernels against one PyTorch call (ms / library ms; below 1 is
    # faster; for K1 the call is the trailing update's batched GEMM
    # alone, `update_library_ms`) and against their bound (bound ms /
    # ms, the share of it reached); K1 also against the parent commit's
    # K1 when it was given
    def lib_ms(r):
        return r["library_ms"] or r.get("update_library_ms")

    log("[vs library] " + json.dumps([
        {"kernel": name, "shape": r["shape"], "dtype": r["dtype"],
         "ms_over_library": r["ms"] / lib_ms(r) if lib_ms(r) else None,
         "bound_over_ms": r["bound_ms"] / r["ms"],
         **({"ms_over_parent": r["ms"] / r["parent_ms"]}
            if r.get("parent_ms") else {})}
        for name in ("panel_lu", "ea_scatter", "lsum")
        for r in res[name]]))
    res["k1_sweep"] = k1_sweep(sched, parent)
    return res


# a middle group of the k=48 schedule (mb 256-4096 with many fronts)
K1_MIDDLE = (6, 2048, 512)

KERNELS = {
    "panel_lu": ("superlu_dist_tpu_torch/csrc/panel_lu.cu",
                 "superlu_dist_tpu/ops/pallas_lu.py:329"),
    "ea_scatter": ("superlu_dist_tpu_torch/csrc/ea_scatter.cu",
                   "superlu_dist_tpu/ops/pallas_scatter.py:165"),
    "lsum": ("superlu_dist_tpu_torch/csrc/lsum.cu",
             "superlu_dist_tpu/ops/pallas_lsum.py:116"),
}


def kernels_line(res, launches):
    out = []
    for name, (src, repl) in KERNELS.items():
        rows = res[name]
        # the headline row: float64 at the largest shape measured, at
        # the main path's single right-hand side for lsum
        f64 = [r for r in rows if r["dtype"] in ("float64",
                                                 "float64/float64")
               and (name != "lsum" or r["shape"][-1] == 1)]
        head = max(f64, key=lambda r: r["bound_ms"])
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": repl, "launches": int(launches[name]),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"]})
    return {"kernels": out}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-k1", default=None,
                    help="a K1 source (panel_lu.cu) of an earlier commit "
                         "to time in turns with this one's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import _cuda
    from superlu_dist_tpu_torch.utils import native, testmat
    t_start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}

    # 1. card
    card = card_line()
    report["card"] = card
    report["versions"] = {"python": sys.version.split()[0],
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "device": torch.cuda.get_device_name(0)}
    log("card:", card)
    log("versions:", json.dumps(report["versions"]))

    # 2. build (the host library too: the planner uses it)
    b = _cuda.build_all(verbose=True)
    if not native.available():
        raise RuntimeError("host library csrc/slu_host.cpp failed to build")
    report["build_s"] = b["seconds"]
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for name, text in b["log"].items():
            f.write(f"== {name}\n{text}\n")
    log(f"build: K1-K3 built in {b['seconds']:.1f} s "
        "(ptxas report in chiprun_out/build.log)")

    # kernels vs plain versions, at shapes from the k=48 schedule
    a48 = testmat.laplacian_3d(48)
    res = kernel_checks(st.plan_factorization(a48),
                        load_parent_k1(args.parent_k1))
    report["kernels"] = res

    # the main path through the user entry point
    lu48, rec = drive("f64 laplacian_3d(48)", st.Options(), a48)
    report["main"] = rec
    # new values on the same plan replay the captured factor graphs
    import numpy as np
    from superlu_dist_tpu_torch.ops import batched, graphs
    sched48 = batched.get_schedule(lu48.plan)
    n_graphs = graphs.graph_count(sched48)
    scale = 1.0 + 0.1 * np.random.default_rng(1).random(a48.nnz)
    a48v = st.CSRMatrix(a48.m, a48.n, a48.indptr, a48.indices,
                        a48.data * scale)
    _, recr = drive("f64 refactor (SAME_PATTERN_SAME_ROWPERM) "
                    "laplacian_3d(48)",
                    st.Options(fact=st.Fact.SAME_PATTERN_SAME_ROWPERM),
                    a48v, lu=lu48)
    if graphs.graph_count(sched48) != n_graphs:
        raise RuntimeError("the refactorization captured new factor graphs")
    report["refactor"] = recr
    opts32 = st.Options(fact=st.Fact.SAME_PATTERN_SAME_ROWPERM,
                        factor_dtype="float32", solve_dtype="float32")
    _, rec32 = drive("f32 factor + f64 refine laplacian_3d(48)", opts32,
                     a48, lu=lu48)
    if rec32["escalations"]:
        raise RuntimeError("mixed-precision run escalated")
    report["mixed"] = rec32
    # refinement on the device: the fused solver, bench.py's
    # configuration first (float32 factor, float64 refinement)
    report["fused"] = [
        fused_phase("f32 factor + f64 refine laplacian_3d(48)", a48,
                    lu48.plan, "float32"),
        fused_phase("f64 laplacian_3d(48)", a48, lu48.plan, "float64")]
    report["spmv"] = spmv_timing(a48, torch.device("cuda"))
    del lu48
    torch.cuda.empty_cache()
    acd = testmat.convection_diffusion_2d(200)
    lucd, recu = drive("f64 convection_diffusion_2d(200)", st.Options(),
                       acd)
    report["unsym"] = recu
    report["fused"].append(fused_phase(
        "f64 convection_diffusion_2d(200)", acd, lucd.plan, "float64"))
    del lucd

    # the compiled-program layer, both arms
    report["graphs"] = [graph_phase("staged laplacian_3d(48)", a48),
                        graph_phase("whole phase convection_diffusion_2d"
                                    "(200)", acd)]

    report["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    # 9. the summary lines, the contract line last
    log(json.dumps(kernels_line(res, rec["launches"])))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
