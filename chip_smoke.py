#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --parent-k1 OLD/panel_lu.cu   # K1 also
                                     # timed against an earlier K1 source

Phases, each of which raises (non-zero exit) on failure:
  1. card      — name, power limit, torch and CUDA versions;
  2. build     — K1–K4 (superlu_dist_tpu_torch/csrc/*.cu) with nvcc for
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
  9. gate      — the numerical-trust layer, with SLU_COND_ESTIMATE=1 set
                 for this phase only (and restored after it):
                 (a) gssvx on laplacian_3d(48) in float64, launch counts
                 set to 0 just before and read just after (each > 0):
                 rcond and its class, the estimator's solves (at most
                 2·SLU_COND_MAXITER + 2), its wall, the solve graphs it
                 captured (the TRANS lane's first solve, reported apart
                 from the replays), the K3 launches inside it (> 0),
                 berr ≤ 64·eps(f64) and a plain (unstamped) result; then a
                 second gated gssvx on the same handle (Fact.FACTORED),
                 which must capture 0 graphs and estimate nothing, its
                 SOLVE wall beside the estimator's;
                 (b) the same rcond with K3 replaced by its plain version
                 (eager sweeps on the card), to 1e-8 relative;
                 (c) convection_diffusion_2d(200) in float64: the card's
                 rcond against the port's inv_norm_est fed by scipy splu
                 solves on the host, to 1e-8 relative;
                 (d) the gauntlet corpus (numerics/gauntlet.py) through
                 gssvx on the card: the count of each outcome, zero
                 silent_wrong and zero untyped, each case's outcome the
                 CPU run's, K1–K3 launches > 0;
                 (e) random_unsymmetric(150, density=0.03) under
                 RowPerm.NOROWPERM, nrhs 3: a typed refusal or a stamped
                 result;
 10. drivers  — the command lines and readers (drivers/, utils/io.py) and
                 the host backend, files in a temporary directory, each
                 `main`'s standard output captured, launch counts set to
                 0 just before each drive and read just after:
                 (a) laplacian_3d(48) f64 written with write_binary,
                 `pddrive.main([file])` on the card: rc 0, inf-norm error
                 ≤ 1e-10 and relative residual ≤ 1e-13 (parsed from its
                 output), K1–K3 launches each > 0, its host wall and the
                 read wall apart;
                 (b) the same file with `--fused --dtype float32 -q`: rc
                 0, launches > 0, the FACT_ESC reruns (0 expected);
                 (c) convection_diffusion_2d(200) f64 as MatrixMarket
                 (scipy.io.mmwrite, read by read_mm), `-s 4 --trans
                 TRANS`: rc 0, K1 and K2 launched (the TRANS lane's
                 forward step runs no K3), the read wall;
                 (d) the same matrix as Harwell-Boeing (scipy.io.hb_write,
                 read by read_hb) through gssvx with backend="host" and
                 backend="torch" on one b: x and diag(U) agree to 1e-10
                 relative, equal tiny-pivot counts, the host factor wall
                 beside the card's;
                 (e) `pdtest.main([])` (laplacian_2d(10), both backends):
                 0 failures, its wall;
 11. complex  — native complex systems on helmholtz_2d(400) (n = 160,000,
                 complex128), launch counts and their per-lane counts set
                 to 0 just before each drive and read just after:
                 (a) gssvx(Options(), a, b): every launch on the complex128
                 lanes of K1–K3 (each > 0), berr ≤ 64·eps(f64);
                 (b) the same plan refactored with a complex64 factor
                 and complex128 refinement (SAME_PATTERN_SAME_ROWPERM):
                 the complex64 lanes of K1 and K2 and K3's c64_c128 lane
                 (the solves run in the promoted complex128), no
                 escalation;
                 (c) CONJ at nrhs 4, refactored on the same plan (K1 and
                 K2 launched; the TRANS lane's forward step is two batched
                 products);
                 (d) the fused solver in complex128, and with a complex64
                 factor and complex128 refinement (its sweeps run K3's
                 c64_c64 lane), at nrhs 1 and 64 as phase 6 runs it
                 (one later call), every launch on the factor's lanes;
                 (e) pddrive on the matrix written as MatrixMarket: rc 0,
                 inf-norm error ≤ 1e-10, relative residual ≤ 1e-13;
                 (f) the host backend against the card on
                 helmholtz_2d(100): x and diag(U) to 1e-10, equal tiny
                 counts;
                 then each complex lane of K1–K3 against its plain version
                 at complex64 and complex128, at the complex schedule's
                 most frequent bucket and its largest (K1 also at k=48's
                 largest shape, (2, 6144, 512)), timed as phase 3 times
                 the real lanes (a complex multiply-add counts as 8 real
                 operations in the bound);
 12. arms     — the core's last switches, each flag set for its drives
                 only and restored after them:
                 (a) SLU_LEVEL_MERGE=1 against off, on laplacian_3d(48)
                 f64 and convection_diffusion_2d(200) f64: per arm the
                 groups, the factor arm (staged or whole phase), the
                 first (capturing) FACT and SOLVE walls with the K1–K3
                 launches of that factorization and solve (each > 0),
                 resident and peak bytes, berr ≤ 64·eps(f64); replayed
                 FACT and FACTORED SOLVE walls in turns; x merged
                 against x off to 1e-10, fewer groups merged, equal
                 tiny counts;
                 (b) SLU_TRISOLVE=legacy FACTORED solves of the
                 laplacian_3d(48) handle at nrhs 1, 8 and 64 and TRANS
                 at nrhs 1, in turns with the packed arm: first and
                 replayed walls, the sweeps' device span, x held to the
                 packed solve's to 1e-10, 0 K3 launches;
                 then K1 at the merged schedules' new shapes (6, 3072,
                 512) and (96, 144, 32), float64 and float32, against
                 its plain version as phase 3 times it, on fronts whose
                 planted tiny pivot is decoupled from the whole front
                 (the card tests' input); on phase 3's input, where that
                 pivot's row and column reach the rest of the front and
                 U grows, K1 against the plain version is reported
                 beside the plain version's own spread between blocks
                 32 and 64 (not gated);
                 (c) SLU_COMPLEX_PAIR=1 on helmholtz_2d(400) complex128:
                 gssvx on pair storage, x against phase 11's native x to
                 1e-10, K1's c128 lane, K2's f64 lane and K3's c128_c128
                 launched (no other lane); the plane->complex decode of
                 the whole handle; a complex64-factor refactor (K1 c64,
                 K2 f32); one later fused call at nrhs 1 (0 graphs
                 captured); at (2, 1024, 512) the copy into the complex
                 working front, K1 c128 and the copies back to planes,
                 each timed apart;
 13. precision — the precision subsystem:
                 (a) gssvx(Options(factor_dtype="bfloat16")) on
                 laplacian_3d(48) (SLU_PREC_LADDER set to the default
                 ladder for this drive only): launches per lane (K1 and
                 K2 bf16, K3 bf16_f64 > 0), the escalation hops and their
                 triggers (the first bfloat16 -> float32), the FACT and
                 FACT_ESC walls, berr ≤ 64·eps(f64); (a2) a bfloat16
                 factor of the same system refined on the card through
                 the doubleword fused solver at nrhs 1 and 64: K3's
                 bf16_f32 lane and K4 launched, berr ≤ DF64_EPS, the
                 second call at each nrhs capturing nothing;
                 (b) make_fused_solver(plan, "float32",
                 residual_mode="doubleword") on laplacian_3d(48) and
                 convection_diffusion_2d(200) (the whole-phase arm), at
                 nrhs 1 and 64, against the fp64-residual lane on the same
                 values in turns: first and later walls, graphs captured
                 (0 after the first), steps, berr ≤ DF64_EPS (fp64 lane ≤
                 64·eps(f64)), the error against x_true of both, K1–K3
                 and K4 launches (K4 > 0 on the doubleword lane), resident
                 and peak bytes;
                 then K4 against its plain version bit for bit on
                 laplacian_3d(48)'s operator at nrhs 1 and 64 (timed
                 beside the float64 ELL matvec and its bound) and on a
                 ragged operator, and the bfloat16 lanes of K1–K3 at
                 phase 3's shapes, timed as phase 3 times kernels beside
                 their plain versions and torch.baddbmm in bfloat16 (K1's
                 update), index_add_ (K2) and two torch.bmm on widened
                 panels (K3);
 14. the kernels line, the card line, and the contract line last.  Each
     real kernel's `launches` is the sum of its launches in phase 4's
     main path (`launches_main`), in phase 9's drive (a)
     (`launches_gate`), in phase 10's drives (a) and (b)
     (`launches_drivers`) and on its real lanes in phase 12's counted
     drives (`launches_arms`: (a)'s first factorizations and solves,
     (c)'s drives and later fused call); each complex lane's is its
     launches in phase 11's drives (a) and (b) and the first fused
     calls of (d), plus that lane's in phase 12 (`launches_arms`).
     The bfloat16 lanes' rows count phase 13 (a)'s and (a2)'s launches,
     K4's row those of (a2) and of (b)'s doubleword calls.
Everything is made from fixed seeds.  Details go to
chiprun_out/chip_smoke.json.
"""

import contextlib
import io
import json
import os
import re
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
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "complex64": 67e12,
              "complex128": 67e12, "bfloat16": 989e12}
# kernel vs plain version, max |diff| / max |plain|: rounding order
# differs (substitution vs Newton inverses, atomics vs ordered adds);
# a complex lane is held to its real precision's tolerance
TOL = {"float32": 1e-4, "float64": 1e-10, "complex64": 1e-4,
       "complex128": 1e-10}
# a bfloat16 lane of K1 or K2 is held element by element, in units of
# each element's own bfloat16 spacing (bf16_ulp): the largest ratio of
# |kernel - plain| to the element's limit (k1_bf16_limit,
# ea_bf16_limit) must not pass 1
BF16_EXCESS_MAX = 1.0
EPS_F32 = 2.0 ** -23
BERR_MAX = 64 * 2.220446049250313e-16
# the doubleword fused solver's step limit on a bfloat16 factor of
# laplacian_3d(48) (phase 13 (a2))
A2_MAX_STEPS = 30


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


def bf16_ulp(x):
    """Elementwise: the spacing of bfloat16 values (8 significant bits)
    at |x|, 2^(e - 8) for |x| in [2^(e-1), 2^e); 0 where x is 0."""
    import torch
    m, e = torch.frexp(x.double().abs())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.exp2((e - 8).double()))


def bf16_excess(got, want, limit) -> float:
    """max over elements of |got - want| / limit (0 where they are
    equal; a difference over a limit of 0 is infinite): ≤ 1 passes."""
    import torch
    d = (got.double() - want.double()).abs()
    return float(torch.where(d == 0, torch.zeros_like(d), d / limit).max())


def k1_bf16_limit(got, want, wb):
    """Per element, how far K1's bfloat16 lane and its plain version may
    differ.  Both factor in float32 (in different orders) and round
    once: an element may land on the neighbouring bfloat16 value (2
    spacings of the larger of the two), and the float32 orders differ by
    a few float32 units of the magnitudes summed (64 units of the
    front's largest |value| in the element's block: the L panel below
    the diagonal block, rows ≥ wb of the first wb columns, or the
    rest)."""
    import torch
    W = want.double().abs()
    mb = W.shape[-1]
    lmask = torch.zeros(mb, mb, dtype=torch.bool, device=W.device)
    lmask[wb:, :wb] = True
    s_l = W.masked_fill(~lmask, 0).amax(dim=(1, 2), keepdim=True)
    s_r = W.masked_fill(lmask, 0).amax(dim=(1, 2), keepdim=True)
    floor = 64 * EPS_F32 * torch.where(lmask, s_l, s_r)
    return 2 * bf16_ulp(torch.maximum(got.double().abs(), W)) + floor


def ea_bf16_limit(F0, upd, bucket):
    """Per element, how far K2's bfloat16 lane and its plain version may
    differ: (c + 1) bfloat16 spacings of S, where c is the number of
    slab values added at the element and S is |F0| plus their |values|
    (the kernel rounds once per record on wide buckets, the plain
    version once; every partial sum is at most S)."""
    import torch
    from superlu_dist_tpu_torch.ops import ea_scatter
    dst, src = ea_scatter.flat_indices(F0, bucket)
    c = torch.zeros(F0.numel(), dtype=torch.float64, device=F0.device)
    c.index_add_(0, dst, torch.ones(dst.numel(), dtype=torch.float64,
                                    device=F0.device))
    S = F0.double().abs().reshape(-1).index_add_(0, dst,
                                                 upd[src].double().abs())
    return ((c + 1) * bf16_ulp(S)).view(F0.shape)


# --------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------

def counters():
    from superlu_dist_tpu_torch.ops import ea_scatter, lsum, panel_lu
    return {"panel_lu": panel_lu.partial_lu_batch,
            "ea_scatter": ea_scatter.ea_scatter_add,
            "lsum": lsum.lsum_panel}


# each drive's solution, by label (phase 12 holds pair storage to
# phase 11's native x)
LAST_X: dict = {}


def drive(label, options, a, lu=None, seed=0, nrhs=1,
          need=("panel_lu", "ea_scatter", "lsum")):
    """One gssvx call through the user entry point, with the kernel
    launch counts (and their per-lane counts) set to 0 just before it
    and read just after; each kernel of `need` must have launched.  A
    complex matrix gets a complex solution to recover."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    rng = np.random.default_rng(seed)
    shape = a.n if nrhs == 1 else (a.n, nrhs)
    xtrue = rng.standard_normal(shape)
    if np.iscomplexobj(a.data):
        xtrue = xtrue + 1j * rng.standard_normal(shape)
    asp = a.to_scipy()
    op = {st.Trans.NOTRANS: asp, st.Trans.TRANS: asp.T,
          st.Trans.CONJ: asp.conj().T}[options.trans]
    b = op @ xtrue
    cs = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    x, lu, stats = st.gssvx(options, a, b, lu=lu)
    wall = time.perf_counter() - t0
    LAST_X[label] = x
    launches = {k: f.launches for k, f in cs.items()}
    lanes = _lanes()
    relerr = float(np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue))
    u = stats.utime
    rec = {
        "label": label, "n": int(a.n), "nnz": int(a.nnz),
        "factor_dtype": lu.effective_options.factor_dtype,
        "wall_s": wall,
        "plan_s": sum(u[p] for p in ("EQUIL", "ROWPERM", "COLPERM",
                                     "ETREE", "SYMBFACT", "DIST")),
        "sched_s": u["SCHED"],
        "factor_s": u["FACT"] + u["FACT_ESC"],
        "fact_s": u["FACT"], "fact_esc_s": u["FACT_ESC"],
        "solve_s": u["SOLVE"], "refine_s": u["REFINE"],
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "berr": float(stats.berr), "relerr": relerr,
        "refine_steps": stats.refine_steps,
        "escalations": stats.escalations,
        "tiny_pivots": stats.tiny_pivots,
        "factor_flops": float(lu.plan.factor_flops),
        "groups": len(lu.device_lu.schedule.groups),
        "launches": launches, "lanes": lanes,
        "result_type": type(x).__name__, "rcond": stats.rcond,
    }
    log(f"[{label}] " + json.dumps(rec))
    if not np.all(np.isfinite(x)) or x.shape != xtrue.shape:
        raise RuntimeError(f"{label}: bad solution")
    if not stats.berr <= BERR_MAX:
        raise RuntimeError(f"{label}: berr {stats.berr} > {BERR_MAX}")
    for k in need:
        if launches[k] <= 0:
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
        f.lanes.clear()


def _lanes():
    """Each kernel's launches per lane since the counts were zeroed."""
    return {k: dict(f.lanes) for k, f in counters().items()}


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
        return wall, out, ctx.graph_count() - g0, _launches(), _lanes()

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
        rng = np.random.default_rng(20 + R)
        xtrue_np = rng.standard_normal((a.n, R))
        if np.iscomplexobj(a.data):
            xtrue_np = xtrue_np + 1j * rng.standard_normal((a.n, R))
        b_np = a.to_scipy() @ xtrue_np
        b = torch.from_numpy(b_np).to(dev)
        xtrue = torch.from_numpy(xtrue_np).to(dev)
        torch.cuda.synchronize()
        m0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        first_s, out, captured, launches, lanes = call(b)
        mem = {"peak_bytes": torch.cuda.max_memory_allocated() - m0,
               "resident_bytes": torch.cuda.memory_allocated() - m0,
               "reserved_bytes": torch.cuda.memory_reserved() - r0}
        relerr = check(out, launches, xtrue, "first call")
        r = {"first_s": first_s, "first_captured": captured,
             "first_launches": launches, "first_lanes": lanes,
             "memory": mem}
        fused, host, later = [], [], []
        for k in range(rounds):
            for kind in (("fused", "gssvx") if k % 2 == 0
                         else ("gssvx", "fused")):
                if kind == "fused":
                    w, out, captured, launches, _ = call(b)
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
# the numerical-trust layer: condition gate, ledger, gauntlet
# --------------------------------------------------------------------

class _EstimatorWatch:
    """Wraps the port's rcond estimator and its solve entry point for
    the gate phase: per estimate, its wall, the solve graphs it
    captured and the K3 launches inside it; per inner solve, its lane,
    wall and the graphs it captured.  `restore()` puts both back."""

    def __init__(self):
        from superlu_dist_tpu_torch.models import gssvx as gm
        from superlu_dist_tpu_torch.numerics import gscon
        from superlu_dist_tpu_torch.ops import graphs, lsum
        self.gm, self.gscon = gm, gscon
        self.orig_solve, self.orig_est = gm.solve, gscon.estimate_rcond
        self.calls, self.solves = [], None

        def solve(lu, b, stats=None):
            if self.solves is None:
                return self.orig_solve(lu, b, stats=stats)
            g0 = graphs.graph_count(lu.device_lu)
            w, x = _synced(lambda: self.orig_solve(lu, b, stats=stats))
            self.solves.append({
                "lane": lu.effective_options.trans.name, "s": w,
                "captured": graphs.graph_count(lu.device_lu) - g0})
            return x

        def estimate(lu, *a, **k):
            self.solves = []
            g0 = graphs.graph_count(lu.device_lu)
            k3 = lsum.lsum_panel.launches
            try:
                w, r = _synced(lambda: self.orig_est(lu, *a, **k))
            finally:
                solves, self.solves = self.solves, None
            self.calls.append({
                "rcond": r, "wall_s": w, "solves": solves,
                "captured": graphs.graph_count(lu.device_lu) - g0,
                "lsum_launches": lsum.lsum_panel.launches - k3})
            return r

        gm.solve, gscon.estimate_rcond = solve, estimate

    def restore(self):
        self.gm.solve = self.orig_solve
        self.gscon.estimate_rcond = self.orig_est


def _rel(x, y):
    return abs(x - y) / abs(y) if y else abs(x - y)


def _estimate_plain_k3(lu):
    """The handle's rcond with K3 replaced by its plain version: the
    sweeps run eagerly on the card (no graph) with lsum_panel_plain."""
    from superlu_dist_tpu_torch.numerics import gscon
    from superlu_dist_tpu_torch.ops import graphs, lsum, trisolve
    saved = trisolve.lsum_panel, graphs.on_card
    trisolve.lsum_panel = lsum.lsum_panel_plain
    graphs.on_card = lambda device: False
    k3 = lsum.lsum_panel.launches
    try:
        w, r = _synced(lambda: gscon.estimate_rcond(lu))
    finally:
        trisolve.lsum_panel, graphs.on_card = saved
    if lsum.lsum_panel.launches != k3:
        raise RuntimeError("gate (b): the plain estimate launched K3")
    return r, w


def _scipy_rcond(a, max_iter):
    """The port's inv_norm_est fed by scipy splu solves on the host."""
    import numpy as np
    import scipy.sparse.linalg as spla
    from superlu_dist_tpu_torch.numerics import gscon
    f = spla.splu(a.to_scipy().tocsc())

    def solve_fn(v, trans):
        return f.solve(np.asarray(v, dtype=np.float64),
                       trans="T" if trans else "N")

    ainv = gscon.inv_norm_est(solve_fn, a.n, np.float64, max_iter=max_iter)
    return float(min(1.0 / (gscon.one_norm(a) * ainv), 1.0))


def gate_phase(a48):
    """Phase 9 (see the module docstring); raises on any failed check.
    Returns (record, launches of the gated laplacian_3d(48) drive)."""
    import numpy as np
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch import flags
    from superlu_dist_tpu_torch.numerics import gauntlet
    from superlu_dist_tpu_torch.numerics.errors import NumericalError
    from superlu_dist_tpu_torch.numerics.ledger import PerturbedResult
    from superlu_dist_tpu_torch.numerics.policy import ConditionPolicy
    from superlu_dist_tpu_torch.ops import batched, graphs
    from superlu_dist_tpu_torch.utils import testmat
    saved = os.environ.get("SLU_COND_ESTIMATE")
    os.environ["SLU_COND_ESTIMATE"] = "1"
    watch = _EstimatorWatch()
    rec = {"card": card_line()}
    try:
        max_iter = flags.env_int("SLU_COND_MAXITER", 5)
        policy = ConditionPolicy.from_env()
        # (a) the gated drive
        lu, drec = drive("gate f64 laplacian_3d(48)", st.Options(), a48,
                         seed=9)
        if len(watch.calls) != 1:
            raise RuntimeError(f"gate: {len(watch.calls)} estimates, not 1")
        est = watch.calls[0]
        solves = est["solves"]
        if not 3 <= len(solves) <= 2 * max_iter + 2:
            raise RuntimeError(f"gate: {len(solves)} estimator solves")
        if est["lsum_launches"] <= 0:
            raise RuntimeError("gate: K3 never launched in the estimate")
        if drec["result_type"] != "ndarray":
            raise RuntimeError(f"gate: a {drec['result_type']} result on "
                               "a well-conditioned matrix")
        rcond = est["rcond"]
        capture = [s for s in solves if s["captured"]]
        replays = [s["s"] for s in solves if not s["captured"]]
        # a second gated solve on the same handle: cached rcond, graphs
        # replayed only
        owners = (lu.device_lu, batched.get_schedule(lu.plan))
        g0 = [graphs.graph_count(o) for o in owners]
        b = a48.to_scipy() @ np.random.default_rng(9).standard_normal(a48.n)
        w2, (x2, _, s2) = _synced(lambda: st.gssvx(
            st.Options(fact=st.Fact.FACTORED), a48, b, lu=lu))
        captured2 = sum(graphs.graph_count(o) - g
                        for o, g in zip(owners, g0))
        if captured2 or len(watch.calls) != 1:
            raise RuntimeError(f"gate: the second gated solve captured "
                               f"{captured2} graphs / re-estimated")
        if not s2.berr <= BERR_MAX or type(x2) is not np.ndarray:
            raise RuntimeError("gate: the FACTORED rung's result")
        rec["a"] = {
            "rcond": rcond, "class": policy.classify(rcond, "float64"),
            "estimator_solves": len(solves),
            "estimator_solves_max": 2 * max_iter + 2,
            "estimator_wall_s": est["wall_s"],
            "estimator_graphs_captured": est["captured"],
            "capturing_solves": capture,
            "replayed_solve_s_median": (statistics.median(replays)
                                        if replays else None),
            "replayed_solve_s": replays,
            "lsum_launches_in_estimate": est["lsum_launches"],
            "berr": drec["berr"], "result_type": drec["result_type"],
            "launches": drec["launches"], "drive": drec,
            "factored_wall_s": w2,
            "factored_solve_s": s2.utime["SOLVE"],
            "factored_refine_s": s2.utime["REFINE"],
            "factored_graphs_captured": captured2}
        # (b) the plain-K3 twin on the same handle
        r_plain, w_plain = _estimate_plain_k3(lu)
        rel_b = _rel(rcond, r_plain)
        rec["b"] = {"rcond_plain_k3": r_plain, "wall_s": w_plain,
                    "rel": rel_b}
        if not rel_b <= 1e-8:
            raise RuntimeError(f"gate (b): rcond {rcond} vs plain K3 "
                               f"{r_plain}")
        del lu, x2
        # (c) convection_diffusion_2d(200) against scipy-fed estimates
        acd = testmat.convection_diffusion_2d(200)
        lucd, crec = drive("gate f64 convection_diffusion_2d(200)",
                           st.Options(), acd, seed=10)
        r_cd = watch.calls[-1]["rcond"]
        w_sp, r_sp = _synced(lambda: _scipy_rcond(acd, max_iter))
        rel_c = _rel(r_cd, r_sp)
        rec["c"] = {"rcond": r_cd, "rcond_scipy": r_sp, "rel": rel_c,
                    "estimator_wall_s": watch.calls[-1]["wall_s"],
                    "estimator_solves": len(watch.calls[-1]["solves"]),
                    "scipy_wall_s": w_sp, "drive": crec}
        if not rel_c <= 1e-8:
            raise RuntimeError(f"gate (c): rcond {r_cd} vs scipy {r_sp}")
        del lucd
        # (d) the gauntlet corpus on the card, each case against the CPU
        _zero_launches()
        recs, summary = gauntlet.run_gauntlet(
            lambda a, b: st.gssvx(None, a, b)[0])
        launches = _launches()
        cpu, _ = gauntlet.run_gauntlet(
            lambda a, b: st.gssvx(None, a, b, device="cpu")[0])
        differ = [(r["name"], r["outcome"], c["outcome"])
                  for r, c in zip(recs, cpu) if r["outcome"] != c["outcome"]]
        rec["d"] = {"summary": summary, "launches": launches,
                    "outcomes": {r["name"]: r["outcome"] for r in recs},
                    "differ_from_cpu": differ}
        if not summary["gate"]["passed"] or differ:
            raise RuntimeError(f"gate (d): {summary['gate']} {differ}")
        for k, v in launches.items():
            if v <= 0:
                raise RuntimeError(f"gate (d): kernel {k} never launched")
        # (e) the NOROWPERM hard case
        ar = testmat.random_unsymmetric(150, density=0.03)
        br = np.random.default_rng(0).standard_normal((ar.n, 3))
        try:
            xr, lur, sr = st.gssvx(
                st.Options(row_perm=st.RowPerm.NOROWPERM), ar, br)
            if not isinstance(xr, PerturbedResult):
                raise RuntimeError("gate (e): a plain result")
            rec["e"] = {"outcome": "stamped", "rcond": sr.rcond,
                        "tiny_pivots": sr.tiny_pivots,
                        "finite": bool(np.isfinite(xr).all())}
        except NumericalError as e:
            rec["e"] = {"outcome": "refused_typed",
                        "error": type(e).__name__,
                        "rcond": getattr(e, "rcond", None)}
    finally:
        watch.restore()
        if saved is None:
            os.environ.pop("SLU_COND_ESTIMATE", None)
        else:
            os.environ["SLU_COND_ESTIMATE"] = saved
    # the drives' records are logged by drive() already
    log("[gate] " + json.dumps(
        {k: ({f: x for f, x in v.items() if f != "drive"}
             if isinstance(v, dict) else v) for k, v in rec.items()},
        default=str))
    return rec, rec["a"]["launches"]


# --------------------------------------------------------------------
# the command lines, the readers and the host backend
# --------------------------------------------------------------------

def _main_captured(main, argv, watch_read=None):
    """(rc, stdout text, host wall s, read wall s or None) of one
    driver `main(argv)`; `watch_read` is the driver module whose
    `read_matrix` is timed apart for this call."""
    read_s = []
    orig = None
    if watch_read is not None:
        orig = watch_read.read_matrix

        def timed(path, **kw):
            t0 = time.perf_counter()
            try:
                return orig(path, **kw)
            finally:
                read_s.append(time.perf_counter() - t0)
        watch_read.read_matrix = timed
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            w, rc = _synced(lambda: main(argv))
    finally:
        if orig is not None:
            watch_read.read_matrix = orig
    return rc, buf.getvalue(), w, (read_s[0] if read_s else None)


def _parsed(out):
    num = r"([-+0-9.eEinfa]+)"
    e = re.search(r"inf-norm error: " + num, out)
    r = re.search(r"relative residual: " + num, out)
    return (float(e.group(1)) if e else float("nan"),
            float(r.group(1)) if r else float("nan"))


def _log_drive(key, rec, card):
    log(f"[drivers {key}] " + json.dumps(
        dict({f: v for f, v in rec.items() if f != "output"}, card=card),
        default=str))


def _pddrive_run(key, label, argv, pddrive, card,
                 need=("panel_lu", "ea_scatter", "lsum")):
    """One pddrive drive, launch counts zeroed just before and read just
    after, logged; raises on a non-zero exit or a kernel of `need`
    never launched."""
    _zero_launches()
    rc, out, wall, read_s = _main_captured(pddrive.main, argv,
                                           watch_read=pddrive)
    launches = _launches()
    err, relres = _parsed(out)
    rec = {"label": label, "argv": [os.path.basename(a) if os.sep in a
                                    else a for a in argv],
           "rc": rc, "wall_s": wall, "read_s": read_s,
           "inf_norm_error": err, "relative_residual": relres,
           "launches": launches, "output": out}
    _log_drive(key, rec, card)
    if rc != 0:
        raise RuntimeError(f"drivers {label}: rc {rc}\n{out}")
    for k in need:
        if launches[k] <= 0:
            raise RuntimeError(f"drivers {label}: {k} never launched")
    return rec


def drivers_phase():
    """Phase 10 (see the module docstring); raises on any failed check.
    Returns (records, launches of drives (a) and (b) summed)."""
    import tempfile
    import numpy as np
    import scipy.io
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.drivers import pddrive, pdtest
    from superlu_dist_tpu_torch.numerics import health
    from superlu_dist_tpu_torch.utils import io as sio, testmat
    card = card_line()
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) pddrive on a binary file, f64
        p48 = os.path.join(tmp, "lap48.bin")
        sio.write_binary(p48, testmat.laplacian_3d(48))
        ra = _pddrive_run("a", "f64 laplacian_3d(48) .bin", [p48],
                          pddrive, card)
        if not (ra["inf_norm_error"] <= 1e-10
                and ra["relative_residual"] <= 1e-13):
            raise RuntimeError(f"drivers (a): {ra['output']}")
        recs["a"] = ra
        # (b) the fused solver, float32 factor; escalations counted at
        # the health seam
        esc = []
        orig_record = health.record

        def record(event, **fields):
            if event == "escalation":
                esc.append(fields)
            return orig_record(event, **fields)
        health.record = record
        try:
            rb = _pddrive_run("b", "fused f32 laplacian_3d(48) .bin",
                              [p48, "--fused", "--dtype", "float32", "-q"],
                              pddrive, card)
        finally:
            health.record = orig_record
        rb["fact_esc"] = len(esc)
        log(f"[drivers b] fact_esc {len(esc)}")
        if not rb["relative_residual"] <= 1e-13:
            raise RuntimeError(f"drivers (b): {rb['output']}")
        recs["b"] = rb
        os.remove(p48)
        # (c) MatrixMarket, TRANS, 4 right-hand sides; the TRANS lane's
        # forward step is two batched products, not K3
        acd = testmat.convection_diffusion_2d(200)
        pmm = os.path.join(tmp, "cd200.mtx")
        scipy.io.mmwrite(pmm, acd.to_scipy())
        recs["c"] = _pddrive_run(
            "c", "f64 convection_diffusion_2d(200) .mtx TRANS",
            [pmm, "-s", "4", "--trans", "TRANS"], pddrive, card,
            need=("panel_lu", "ea_scatter"))
        # (d) Harwell-Boeing, host backend against the card
        phb = os.path.join(tmp, "cd200.rua")
        scipy.io.hb_write(phb, acd.to_scipy().tocsc())
        t0 = time.perf_counter()
        ahb = sio.read_hb(phb)
        read_hb_s = time.perf_counter() - t0
        if (ahb.to_scipy() != acd.to_scipy()).nnz:
            raise RuntimeError("drivers (d): read_hb differs from the "
                               "matrix written")
        b = ahb.to_scipy() @ np.random.default_rng(10).standard_normal(
            ahb.n)
        wh, (xh, luh, sh) = _synced(lambda: st.gssvx(
            st.Options(), ahb, b, backend="host"))
        wt, (xt, lut, stt) = _synced(lambda: st.gssvx(
            st.Options(), ahb, b, backend="torch"))
        rel_x = float(np.max(np.abs(xh - xt)) / np.max(np.abs(xh)))
        dh, dt = st.get_diag_u(luh), st.get_diag_u(lut)
        rel_d = float(np.max(np.abs(dh - dt)) / np.max(np.abs(dh)))
        recs["d"] = {"read_hb_s": read_hb_s, "n": int(ahb.n),
                     "nnz": int(ahb.nnz),
                     "host": {"wall_s": wh, "factor_s": sh.utime["FACT"],
                              "solve_s": sh.utime["SOLVE"],
                              "refine_s": sh.utime["REFINE"],
                              "berr": sh.berr, "tiny": sh.tiny_pivots},
                     "torch": {"wall_s": wt, "factor_s": stt.utime["FACT"],
                               "solve_s": stt.utime["SOLVE"],
                               "refine_s": stt.utime["REFINE"],
                               "berr": stt.berr, "tiny": stt.tiny_pivots},
                     "rel_x": rel_x, "rel_diag_u": rel_d}
        _log_drive("d", recs["d"], card)
        if not (rel_x <= 1e-10 and rel_d <= 1e-10
                and sh.tiny_pivots == stt.tiny_pivots):
            raise RuntimeError(f"drivers (d): {recs['d']}")
        del luh, lut
    # (e) the option sweep, both backends, on the card
    rc, out, wall, _ = _main_captured(pdtest.main, [])
    recs["e"] = {"rc": rc, "wall_s": wall, "summary": out.strip()
                 .splitlines()[-1] if out.strip() else ""}
    _log_drive("e", recs["e"], card)
    if rc != 0:
        raise RuntimeError(f"drivers (e): pdtest rc {rc}\n{out}")
    launches = {k: ra["launches"][k] + rb["launches"][k]
                for k in ra["launches"]}
    return recs, launches


# --------------------------------------------------------------------
# native complex systems
# --------------------------------------------------------------------

# helmholtz_2d(400): the shifted 2D Laplacian a frequency-domain solver
# factors, n = 160,000, complex128
COMPLEX_K = 400
# K1's largest shape at k=48, run by the complex lanes too
K1_LARGEST_K48 = (2, 6144, 512)
# the complex lanes of each kernel (the suffixes of their launchers)
COMPLEX_LANES = {"panel_lu": ("c64", "c128"), "ea_scatter": ("c64", "c128"),
                 "lsum": ("c64_c64", "c128_c128", "c64_c128")}


def _check_lanes(label, lanes, want):
    """Every launch of the drive on the lanes of `want` (kernel -> set),
    each of them launched."""
    got = {k: {ln for ln, c in v.items() if c > 0} for k, v in lanes.items()}
    if got != want:
        raise RuntimeError(f"{label}: lanes {lanes}, expected {want}")


def complex_phase():
    """Phase 11 (see the module docstring); raises on any failed check.
    Returns (records, the complex kernel checks, the launches per lane
    of drives (a) and (b) summed)."""
    import gc
    import tempfile
    import numpy as np
    import scipy.io
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.drivers import pddrive
    from superlu_dist_tpu_torch.utils import testmat
    card = card_line()
    a = testmat.helmholtz_2d(COMPLEX_K)
    recs = {}
    same = st.Fact.SAME_PATTERN_SAME_ROWPERM
    # (a) the user entry point in complex128
    lu, recs["a"] = drive(f"c128 helmholtz_2d({COMPLEX_K})", st.Options(),
                          a, seed=30)
    _check_lanes("complex (a)", recs["a"]["lanes"],
                 {"panel_lu": {"c128"}, "ea_scatter": {"c128"},
                  "lsum": {"c128_c128"}})
    # (b) a complex64 factor, complex128 refinement (gssvx solves in the
    # promoted dtype of the factors and the right-hand side: complex128)
    _, recs["b"] = drive(
        f"c64 factor + c128 refine helmholtz_2d({COMPLEX_K})",
        st.Options(fact=same, factor_dtype="float32"), a, lu=lu, seed=31)
    _check_lanes("complex (b)", recs["b"]["lanes"],
                 {"panel_lu": {"c64"}, "ea_scatter": {"c64"},
                  "lsum": {"c64_c128"}})
    if recs["b"]["escalations"]:
        raise RuntimeError("complex (b): the complex64 factor escalated")
    # (c) CONJ at nrhs 4; the TRANS lane's forward step is two batched
    # products, not K3
    _, recs["c"] = drive(f"c128 CONJ nrhs 4 helmholtz_2d({COMPLEX_K})",
                         st.Options(fact=same, trans=st.Trans.CONJ), a,
                         lu=lu, seed=32, nrhs=4,
                         need=("panel_lu", "ea_scatter"))
    # (d) refinement on the device, in complex128 and with a complex64
    # factor and complex128 refinement, whose sweeps run in the factor's
    # dtype (K3's c64_c64 lane)
    recs["d"] = [fused_phase(f"{w} helmholtz_2d({COMPLEX_K})", a, lu.plan,
                             dt, rounds=1)
                 for w, dt in (("c128", "complex128"),
                               ("c64 factor + c128 refine", "complex64"))]
    for rd, ln in zip(recs["d"], ("c128", "c64")):
        for R, r in rd["nrhs"].items():
            _check_lanes(f"complex (d) {ln} nrhs {R}", r["first_lanes"],
                         {"panel_lu": {ln}, "ea_scatter": {ln},
                          "lsum": {f"{ln}_{ln}"}})
    plan = lu.plan
    del lu
    gc.collect()
    torch.cuda.empty_cache()
    # (e) pddrive on the matrix written as MatrixMarket
    with tempfile.TemporaryDirectory() as tmp:
        pmm = os.path.join(tmp, f"helm{COMPLEX_K}.mtx")
        t0 = time.perf_counter()
        scipy.io.mmwrite(pmm, a.to_scipy())
        write_s = time.perf_counter() - t0
        re_ = _pddrive_run("complex e", f"c128 helmholtz_2d({COMPLEX_K}) "
                           ".mtx", [pmm], pddrive, card)
    re_["write_s"] = write_s
    if not (re_["inf_norm_error"] <= 1e-10
            and re_["relative_residual"] <= 1e-13
            and "dtype=complex128" in re_["output"]):
        raise RuntimeError(f"complex (e): {re_['output']}")
    recs["e"] = re_
    # (f) the host backend against the card
    a100 = testmat.helmholtz_2d(100)
    rng = np.random.default_rng(33)
    b = a100.to_scipy() @ (rng.standard_normal(a100.n)
                           + 1j * rng.standard_normal(a100.n))
    wh, (xh, luh, sh) = _synced(lambda: st.gssvx(st.Options(), a100, b,
                                                 backend="host"))
    wt, (xt, lut, stt) = _synced(lambda: st.gssvx(st.Options(), a100, b,
                                                  backend="torch"))
    rel_x = float(np.max(np.abs(xh - xt)) / np.max(np.abs(xh)))
    dh, dt = st.get_diag_u(luh), st.get_diag_u(lut)
    rel_d = float(np.max(np.abs(dh - dt)) / np.max(np.abs(dh)))
    recs["f"] = {"n": int(a100.n), "host_wall_s": wh, "card_wall_s": wt,
                 "host_factor_s": sh.utime["FACT"],
                 "card_factor_s": stt.utime["FACT"],
                 "berr": [sh.berr, stt.berr],
                 "tiny": [sh.tiny_pivots, stt.tiny_pivots],
                 "rel_x": rel_x, "rel_diag_u": rel_d}
    _log_drive("complex f", recs["f"], card)
    if not (rel_x <= 1e-10 and rel_d <= 1e-10 and dt.dtype == np.complex128
            and sh.tiny_pivots == stt.tiny_pivots
            and max(sh.berr, stt.berr) <= BERR_MAX):
        raise RuntimeError(f"complex (f): {recs['f']}")
    del luh, lut
    # each complex lane against its plain version, at the complex
    # schedule's shapes
    kres = kernel_checks(plan, dtypes=COMPLEX, pairs=COMPLEX_PAIRS,
                         k1_extra=K1_LARGEST_K48, many=False, sweep=False)
    drives = [recs["a"]["lanes"], recs["b"]["lanes"]] + [
        r["first_lanes"] for rd in recs["d"] for r in rd["nrhs"].values()]
    lanes = {k: {ln: sum(d[k].get(ln, 0) for d in drives)
                 for ln in COMPLEX_LANES[k]} for k in COMPLEX_LANES}
    return recs, kres, lanes


# --------------------------------------------------------------------
# the core's last arms: level merging, the legacy sweep, pair storage
# --------------------------------------------------------------------

@contextlib.contextmanager
def _env(**kw):
    """Set the environment flags `kw` for one drive, restored after."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _count_lanes(into, lanes):
    for k, v in lanes.items():
        for ln, c in v.items():
            into.setdefault(k, {})
            into[k][ln] = into[k].get(ln, 0) + c


def merge_phase(label, a, lanes, rounds=3):
    """Phase 12 (a) on one matrix: SLU_LEVEL_MERGE off and on, each set
    for its drives only.  Per arm: groups, factor arm, the first
    (capturing) factorization and solve with the K1-K3 launches of that
    factorization and solve (counts set to 0 just before, each > 0),
    resident and peak device bytes, berr; then replayed FACT and
    FACTORED SOLVE walls in turns.  x on merging agrees with x off to
    1e-10.  Returns (record, the off arm's handle, plan)."""
    import gc
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched, graphs
    rng = np.random.default_rng(41)
    xt = rng.standard_normal(a.n)
    b = a.to_scipy() @ xt
    plan = st.plan_factorization(a)
    rec = {"label": label, "n": int(a.n), "arms": {}}
    lus, xs = {}, {}
    for arm in ("off", "on"):
        with _env(SLU_LEVEL_MERGE=int(arm == "on")):
            sched = batched.get_schedule(plan)
            sched.to_device(torch.device("cuda"))
            gc.collect()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            stats = st.Stats()
            fw, lu = _synced(lambda: st.factorize(a, plan=plan,
                                                  stats=stats))
            sw, x = _synced(lambda: st.solve(lu, b, stats=stats))
            launches, ln = _launches(), _lanes()
            _count_lanes(lanes, ln)
            torch.cuda.synchronize()
            r = {"groups": len(sched.groups),
                 "arm": ("staged" if batched.staged_enabled(sched)
                         else "whole phase"),
                 "front_cells": int(sum(g.n_loc * g.mb * g.mb
                                        for g in sched.groups)),
                 "first_fact_s": fw, "first_solve_s": sw,
                 "launches": launches,
                 "resident_bytes": torch.cuda.memory_allocated() - m0,
                 "peak_bytes": torch.cuda.max_memory_allocated() - m0,
                 "graphs": graphs.graph_count(sched)
                 + graphs.graph_count(lu.device_lu),
                 "berr": float(stats.berr),
                 "tiny_pivots": int(stats.tiny_pivots),
                 "relerr": float(np.abs(x - xt).max() / np.abs(xt).max())}
            if not r["berr"] <= BERR_MAX:
                raise RuntimeError(f"{label} merge {arm}: berr {r['berr']}")
            for k, v in launches.items():
                if v <= 0:
                    raise RuntimeError(f"{label} merge {arm}: kernel {k} "
                                       "was never launched")
            rec["arms"][arm] = r
            lus[arm], xs[arm] = lu, x
    walls = {(arm, w): [] for arm in ("off", "on")
             for w in ("fact", "solve")}
    for k in range(rounds):
        for arm in (("off", "on") if k % 2 == 0 else ("on", "off")):
            with _env(SLU_LEVEL_MERGE=int(arm == "on")):
                fw, lu_r = _synced(lambda: st.factorize(a, plan=plan))
                sw, _ = _synced(lambda: st.solve(lus[arm], b))
                walls[(arm, "fact")].append(fw)
                walls[(arm, "solve")].append(sw)
                del lu_r
    for arm in ("off", "on"):
        for w in ("fact", "solve"):
            rec["arms"][arm][f"{w}_s"] = statistics.median(walls[(arm, w)])
            rec["arms"][arm][f"{w}_s_all"] = walls[(arm, w)]
    rel = float(np.abs(xs["on"] - xs["off"]).max()
                / np.abs(xs["off"]).max())
    rec["x_on_vs_off"] = rel
    log(f"[arms merge {label}] " + json.dumps(rec))
    on, off = rec["arms"]["on"], rec["arms"]["off"]
    if not (rel <= 1e-10 and on["groups"] < off["groups"]
            and on["tiny_pivots"] == off["tiny_pivots"]):
        raise RuntimeError(f"{label} merge: {rec}")
    return rec, lus["off"], plan


def legacy_phase(lu, a, rounds=3):
    """Phase 12 (b): FACTORED solves of one handle (laplacian_3d(48)
    f64) on SLU_TRISOLVE=legacy against the packed arm, at nrhs 1, 8
    and 64 and TRANS at nrhs 1: the first (capturing) and the replayed
    host walls in turns, the device span of the sweeps alone (b on the
    card), x held to the packed solve's to 1e-10, and no K3 launch on
    the legacy arm."""
    import numpy as np
    import torch
    from superlu_dist_tpu_torch.ops import batched, lsum, trisolve
    d = lu.device_lu
    out = {"arm": ("staged" if isinstance(d, batched.StagedLU)
                   else "whole phase"), "cases": []}
    for R, trans in ((1, False), (8, False), (64, False), (1, True)):
        b = np.random.default_rng(50 + R).standard_normal((a.n, R))
        fn = batched.solve_device_trans if trans else batched.solve_device
        bd = torch.from_numpy(b).to("cuda")
        r = {"nrhs": R, "trans": trans}
        xs = {}
        for arm in ("merged", "legacy"):
            with _env(SLU_TRISOLVE=arm):
                lsum.lsum_panel.launches = 0
                r[f"{arm}_first_s"], xs[arm] = _synced(lambda: fn(d, b))
                r[f"{arm}_k3_launches"] = lsum.lsum_panel.launches
        walls = {"merged": [], "legacy": []}
        for k in range(rounds):
            for arm in (("merged", "legacy") if k % 2 == 0
                        else ("legacy", "merged")):
                with _env(SLU_TRISOLVE=arm):
                    lsum.lsum_panel.launches = 0
                    w, _ = _synced(lambda: fn(d, b))
                    walls[arm].append(w)
                    if arm == "legacy" and lsum.lsum_panel.launches:
                        raise RuntimeError("legacy solve launched K3")
        for arm in ("merged", "legacy"):
            r[f"{arm}_s"] = statistics.median(walls[arm])
            with _env(SLU_TRISOLVE=arm):
                r[f"{arm}_span_ms"] = time_cuda(
                    lambda: trisolve.solve(d, bd, trans))
        r["rel"] = float(np.abs(xs["legacy"] - xs["merged"]).max()
                         / np.abs(xs["merged"]).max())
        out["cases"].append(r)
        if not (r["rel"] <= 1e-10 and r["legacy_k3_launches"] == 0
                and (trans or r["merged_k3_launches"] > 0)):
            raise RuntimeError(f"legacy sweep: {r}")
    log("[arms legacy laplacian_3d(48)] " + json.dumps(out))
    return out


def pair_copies(N, mb, wb, dtype="complex128"):
    """K1's complex lane on the pair path at one (N, mb, wb): the copy
    of the two planes into the complex working front, K1 on it, and
    the copies of (L, U, Li, Ui, update slab) back to planes, each
    timed apart in turns (device ms); K1 against its plain version
    through check_panel_lu."""
    import torch
    from superlu_dist_tpu_torch.ops import batched
    tdt = _tdt(dtype)
    rdt = tdt.to_real()
    g = torch.Generator(device="cuda").manual_seed(mb)
    P = torch.randn(2, N * mb * mb, generator=g, dtype=rdt, device="cuda")
    Fc = torch.complex(P[0], P[1]).view(N, mb, mb)
    rb = mb - wb
    outs = [torch.empty(2, N * s, dtype=rdt, device="cuda")
            for s in (mb * wb, wb * mb, wb * wb, wb * wb, rb * rb)]
    parts = (Fc[:, :, :wb], Fc[:, :wb, :], Fc[:, :wb, :wb],
             Fc[:, :wb, :wb], Fc[:, wb:, wb:])

    def copy_out():
        for o, c in zip(outs, parts):
            batched._encode_into(o, c)

    tm = time_turns({"copy_in": lambda: torch.complex(P[0], P[1]),
                     "copy_out": copy_out}, rounds=5, inner=5)
    k1 = check_panel_lu(N, mb, wb, dtype)
    nbytes = 2 * (N * mb * mb * tdt.itemsize)
    rec = {"shape": [N, mb, wb], "dtype": dtype,
           "copy_in_ms": tm["copy_in"], "copy_out_ms": tm["copy_out"],
           "copy_in_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "k1": k1}
    log("[arms pair copies] " + json.dumps(rec))
    return rec


def pair_phase(lanes):
    """Phase 12 (c): SLU_COMPLEX_PAIR=1 on helmholtz_2d(400) complex128,
    set for these drives only: gssvx on pair storage (x against phase
    11's native x to 1e-10; K1's c128 lane and K2's f64 lane, K3's
    c128_c128), the whole handle's plane->complex decode timed, a
    complex64-factor refactor (K1 c64, K2 f32), one later fused call
    at nrhs 1, and the copies of K1's pair path at (2, 1024, 512)."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.utils import testmat
    a = testmat.helmholtz_2d(COMPLEX_K)
    rec = {}
    native = LAST_X[f"c128 helmholtz_2d({COMPLEX_K})"]
    with _env(SLU_COMPLEX_PAIR=1):
        lu, rec["gssvx"] = drive(f"pair c128 helmholtz_2d({COMPLEX_K})",
                                 st.Options(), a, seed=30)
        _count_lanes(lanes, rec["gssvx"]["lanes"])
        _check_lanes("pair (c) gssvx", rec["gssvx"]["lanes"],
                     {"panel_lu": {"c128"}, "ea_scatter": {"f64"},
                      "lsum": {"c128_c128"}})
        x = LAST_X[f"pair c128 helmholtz_2d({COMPLEX_K})"]
        rel = float(np.abs(x - native).max() / np.abs(native).max())
        rec["x_vs_native"] = rel
        if not (rel <= 1e-10 and batched._lu_is_pair(lu.device_lu)):
            raise RuntimeError(f"pair (c): x vs native {rel}")
        rec["decode_ms"] = time_cuda(
            lambda: batched.decode_pair(lu.device_lu))
        rec["held_bytes"] = st.query_space(lu)["held_bytes"]
        _, rec["c64"] = drive(
            f"pair c64 factor + c128 refine helmholtz_2d({COMPLEX_K})",
            st.Options(fact=st.Fact.SAME_PATTERN_SAME_ROWPERM,
                       factor_dtype="float32"), a, lu=lu, seed=31)
        _count_lanes(lanes, rec["c64"]["lanes"])
        _check_lanes("pair (c) c64", rec["c64"]["lanes"],
                     {"panel_lu": {"c64"}, "ea_scatter": {"f32"},
                      "lsum": {"c64_c128"}})
        step = batched.make_fused_solver(lu.plan, "complex128")
        ctx = step.context
        dev = ctx.device
        vals = torch.from_numpy(a.data).to(dev)
        rng = np.random.default_rng(32)
        xt = rng.standard_normal((a.n, 1)) + 1j * rng.standard_normal(
            (a.n, 1))
        b = torch.from_numpy(a.to_scipy() @ xt).to(dev)
        fw, _ = _synced(lambda: step(vals, b))
        g0 = ctx.graph_count()
        _zero_launches()
        lw, out = _synced(lambda: step(vals, b))
        fl = _lanes()
        _count_lanes(lanes, fl)
        rec["fused"] = {"pair": ctx.pair, "first_s": fw, "later_s": lw,
                        "captured_later": ctx.graph_count() - g0,
                        "berr": float(out[1]), "steps": int(out[2]),
                        "lanes": fl,
                        "relerr": float(np.abs(out[0].cpu().numpy() - xt)
                                        .max() / np.abs(xt).max())}
        log("[arms pair fused] " + json.dumps(rec["fused"]))
        if not (ctx.pair and rec["fused"]["captured_later"] == 0
                and rec["fused"]["berr"] <= BERR_MAX
                and rec["fused"]["relerr"] <= 1e-10):
            raise RuntimeError(f"pair (c) fused: {rec['fused']}")
        del lu, step, ctx
    rec["copies"] = pair_copies(2, 1024, 512)
    return rec


def arms_phase():
    """Phase 12 (see the module docstring); raises on any failed check.
    Returns (records, the launches per kernel and lane of its drives)."""
    import gc
    import torch
    from superlu_dist_tpu_torch.utils import testmat
    lanes: dict = {}
    recs = {}
    a48 = testmat.laplacian_3d(48)
    recs["merge_k48"], lu48, plan48 = merge_phase("laplacian_3d(48)", a48,
                                                  lanes)
    recs["legacy"] = legacy_phase(lu48, a48)
    del lu48, plan48
    gc.collect()
    torch.cuda.empty_cache()
    recs["merge_cd200"], _, _ = merge_phase(
        "convection_diffusion_2d(200)", testmat.convection_diffusion_2d(200),
        lanes)
    gc.collect()
    torch.cuda.empty_cache()
    # K1 at the merged schedules' new shapes, on fronts whose planted
    # tiny pivot is decoupled from the whole front (the card tests'
    # input); the coupled input's spread is reported beside it
    recs["k1_merged"], recs["k1_growth"] = [], []
    for N, mb, wb in K1_MERGED:
        for dt in REAL:
            r = check_panel_lu(N, mb, wb, dt, decouple=True)
            log("[arms kernel panel_lu] " + json.dumps(r))
            recs["k1_merged"].append(r)
        recs["k1_growth"].append(k1_growth_spread(N, mb, wb))
    recs["pair"] = pair_phase(lanes)
    return recs, lanes


# the merged schedules' new K1 shapes: laplacian_3d(48)'s widest new
# group and convection_diffusion_2d(200)'s ragged 144-wide frames
K1_MERGED = ((6, 3072, 512), (96, 144, 32))


# --------------------------------------------------------------------
# the precision subsystem: bfloat16 factors and the escalation ladder,
# double-word refinement on the card (kernel K4)
# --------------------------------------------------------------------

@contextlib.contextmanager
def _escalations():
    """The escalation events the port's health seam receives during the
    block, in order (from, to, trigger, berr)."""
    from superlu_dist_tpu_torch.numerics import health
    events, orig = [], health.record

    def record(event, **kw):
        if event == "escalation":
            events.append({"from": kw["factor_dtype"],
                           "to": kw["to_dtype"],
                           "trigger": kw["trigger"], "berr": kw["berr"]})
        orig(event, **kw)

    health.record = record
    try:
        yield events
    finally:
        health.record = orig


def _k4():
    from superlu_dist_tpu_torch.ops import df64_spmv
    return df64_spmv.df64_ell_spmv


def bf16_phase(a48, plan48, lanes):
    """Phase 13 (a): bfloat16 factors.  (a) gssvx(Options(factor_dtype=
    "bfloat16")) on laplacian_3d(48) (float64 refinement on the host,
    the sweeps in float64: K3's bf16_f64 lane), with SLU_PREC_LADDER set
    to the default ladder for this drive only: the launches per lane
    (K1 and K2 bf16, K3 bf16_f64 > 0), the escalation hops and their
    triggers (the first bfloat16 -> float32), the FACT and FACT_ESC
    walls, berr ≤ 64·eps(f64).  (a2) a bfloat16 factor of the same
    system refined to the double-word class on the card:
    make_fused_solver(plan48, "bfloat16", residual_mode="doubleword",
    max_steps=A2_MAX_STEPS) at nrhs 1 and 64, two calls each (the
    second captures nothing), the sweeps in float32 (K3's bf16_f32
    lane: its own kernel at nrhs 1, the float32-panel lane on widened
    panels at 64), K4 > 0, berr ≤ DF64_EPS and the error against
    x_true."""
    import numpy as np
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.precision.doubleword import DF64_EPS
    with _env(SLU_PREC_LADDER="bfloat16,float32,float64"), \
            _escalations() as hops:
        _, rec = drive("bf16 factor + f64 refine laplacian_3d(48)",
                       st.Options(factor_dtype="bfloat16"), a48)
    rec["hops"] = hops
    log("[precision a hops] " + json.dumps(hops))
    if hops and (hops[0]["from"], hops[0]["to"]) != ("bfloat16",
                                                     "float32"):
        raise RuntimeError(f"first escalation hop {hops[0]}")
    if len(hops) != rec["escalations"]:
        raise RuntimeError(f"{len(hops)} hop events for "
                           f"{rec['escalations']} escalations")
    _count_lanes(lanes, rec["lanes"])
    recs = {"a": rec}

    step = batched.make_fused_solver(plan48, "bfloat16",
                                     residual_mode="doubleword",
                                     max_steps=A2_MAX_STEPS)
    dev = step.context.device
    vals = torch.from_numpy(a48.data).to(dev)
    k4 = _k4()
    label = "bf16 factor + df64 fused refine laplacian_3d(48)"
    rec2 = {"label": label, "n": int(a48.n), "nrhs": {},
            "launches": {}, "lanes": {}}
    for R in (1, 64):
        xt_np = np.random.default_rng(50 + R).standard_normal((a48.n, R))
        b = torch.from_numpy(a48.to_scipy() @ xt_np).to(dev)
        walls = []
        for call in range(2):
            _zero_launches()
            k4.launches = 0
            k4.lanes.clear()
            g0 = step.context.graph_count()
            w, out = _synced(lambda: step(vals, b))
            walls.append({"wall_s": w,
                          "captured": step.context.graph_count() - g0})
            for k, v in {**_launches(), "df64_spmv": k4.launches}.items():
                rec2["launches"][k] = rec2["launches"].get(k, 0) + v
            _count_lanes(rec2["lanes"], {**_lanes(),
                                         "df64_spmv": dict(k4.lanes)})
        x, berr = out[0], float(out[1])
        rr = {"walls": walls, "steps": int(out[2]), "berr": berr,
              "relerr": float(np.abs(x.cpu().numpy() - xt_np).max()
                              / np.abs(xt_np).max())}
        rec2["nrhs"][R] = rr
        log(f"[precision a2 nrhs {R}] " + json.dumps(rr))
        if (not berr <= DF64_EPS or x.shape != (a48.n, R)
                or not bool(torch.isfinite(x).all())):
            raise RuntimeError(f"{label} nrhs {R}: berr {berr} > "
                               f"{DF64_EPS} or a bad solution")
        if walls[1]["captured"]:
            raise RuntimeError(f"{label} nrhs {R}: the second call "
                               "captured")
        del b, out, x
    del step, vals
    log("[precision a2] " + json.dumps({k: rec2[k] for k in
                                        ("launches", "lanes")}))
    for rr, want in ((rec, {"panel_lu": "bf16", "ea_scatter": "bf16",
                            "lsum": "bf16_f64"}),
                     (rec2, {"panel_lu": "bf16", "ea_scatter": "bf16",
                             "lsum": "bf16_f32", "df64_spmv": "df64"})):
        got = {k: rr["lanes"][k].get(ln, 0) for k, ln in want.items()}
        if min(got.values()) <= 0:
            raise RuntimeError(f"{rr['label']}: a lane was never "
                               f"launched: {got}")
    _count_lanes(lanes, {k: v for k, v in rec2["lanes"].items()
                         if k != "df64_spmv"})
    recs["a2"] = rec2
    return recs, rec2["launches"]["df64_spmv"]


def df64_phase(label, a, plan, rounds=3):
    """Phase 13 (b) on one matrix: make_fused_solver(plan, "float32",
    residual_mode="doubleword") (the whole-phase arm, which the
    doubleword residual forces) against the fp64-residual lane on the
    same float32 factor, vals and b on the card, nrhs 1 and 64: first
    (capturing) and later walls in turns, the graphs each call captured
    (0 after the first), steps, berr (≤ DF64_EPS on the doubleword
    lane, ≤ 64·eps(f64) on the fp64 lane) and the error against x_true
    of both, the K1–K3 and K4 launches of each call (counts set to 0
    just before it; K4 > 0 on the doubleword lane), resident and peak
    bytes of the first call."""
    import numpy as np
    import torch
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.precision.doubleword import DF64_EPS
    dw = batched.make_fused_solver(plan, "float32",
                                   residual_mode="doubleword")
    fp = batched.make_fused_solver(plan, "float32", residual_mode="fp64")
    if (dw.residual_mode, dw.spmv_layout) != ("doubleword", "ell"):
        raise RuntimeError(f"{label}: doubleword lane resolved to "
                           f"{dw.residual_mode}/{dw.spmv_layout}")
    dev = dw.context.device
    vals = torch.from_numpy(a.data).to(dev)
    k4 = _k4()
    rec = {"label": label, "n": int(a.n),
           "arm": {k: "staged" if s.context.staged else "whole phase"
                   for k, s in (("df64", dw), ("fp64", fp))},
           "k4_launches": 0, "k4_lanes": {}, "nrhs": {}}

    def call(step, b):
        g0 = step.context.graph_count()
        _zero_launches()
        k4.launches = 0
        k4.lanes.clear()
        wall, out = _synced(lambda: step(vals, b))
        launches = {**_launches(), "df64_spmv": k4.launches}
        lanes = {**_lanes(), "df64_spmv": dict(k4.lanes)}
        return wall, out, step.context.graph_count() - g0, launches, lanes

    def check(kind, out, launches, lanes, xtrue, what):
        x, berr = out[0], float(out[1])
        if (x.shape != xtrue.shape or x.dtype != torch.float64
                or not bool(torch.isfinite(x).all())):
            raise RuntimeError(f"{label} {kind} {what}: bad solution")
        bound = DF64_EPS if kind == "df64" else BERR_MAX
        if not berr <= bound:
            raise RuntimeError(f"{label} {kind} {what}: berr {berr} > "
                               f"{bound}")
        need = ["panel_lu", "ea_scatter", "lsum"]
        if kind == "df64":
            need.append("df64_spmv")
            rec["k4_launches"] += launches["df64_spmv"]
            _count_lanes(rec["k4_lanes"], {"df64_spmv":
                                           lanes["df64_spmv"]})
        elif launches["df64_spmv"]:
            raise RuntimeError(f"{label}: the fp64 lane launched K4")
        for k in need:
            if launches[k] <= 0:
                raise RuntimeError(f"{label} {kind} {what}: kernel {k} "
                                   "was never launched")
        return float((x - xtrue).abs().max() / xtrue.abs().max())

    for R in (1, 64):
        rng = np.random.default_rng(40 + R)
        xtrue_np = rng.standard_normal((a.n, R))
        b = torch.from_numpy(a.to_scipy() @ xtrue_np).to(dev)
        xtrue = torch.from_numpy(xtrue_np).to(dev)
        r = {}
        for kind, step in (("df64", dw), ("fp64", fp)):
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            first_s, out, cap, launches, lanes = call(step, b)
            mem = {"peak_bytes": torch.cuda.max_memory_allocated() - m0,
                   "resident_bytes": torch.cuda.memory_allocated() - m0}
            r[kind] = {"first_s": first_s, "first_captured": cap,
                       "first_launches": launches, "first_lanes": lanes,
                       "memory": mem, "steps": int(out[2]),
                       "berr": float(out[1]),
                       "relerr": check(kind, out, launches, lanes, xtrue,
                                       "first call"),
                       "later": []}
        for k in range(rounds):
            for kind in (("df64", "fp64") if k % 2 == 0
                         else ("fp64", "df64")):
                step = dw if kind == "df64" else fp
                w, out, cap, launches, lanes = call(step, b)
                if cap:
                    raise RuntimeError(f"{label} {kind}: a later call "
                                       f"captured {cap} graphs")
                r[kind]["later"].append({
                    "wall_s": w, "steps": int(out[2]),
                    "berr": float(out[1]), "launches": launches,
                    "relerr": check(kind, out, launches, lanes, xtrue,
                                    "later call")})
        for kind in r:
            r[kind]["later_s"] = statistics.median(
                c["wall_s"] for c in r[kind]["later"])
        rec["nrhs"][R] = r
        log(f"[precision b {label} nrhs {R}] " + json.dumps(
            {k: {f: v[f] for f in ("first_s", "first_captured", "later_s",
                                   "steps", "berr", "relerr", "memory")}
                 for k, v in r.items()}))
    rec["graphs"] = dw.context.graph_count()
    return rec


def check_df64(a, label, timed=True):
    """K4 against its plain version on the doubleword operator of `a`
    at nrhs 1 and 64: bit for bit (hi and lo words), the joined product
    against the float64 ELL product, and (with `timed`) both timed in
    turns beside the float64 ELL matvec of the same operator
    (DeviceSpMV.matvec) and the bound.  No single PyTorch call computes
    a double-word product: library_ms is None."""
    import numpy as np
    import torch
    from superlu_dist_tpu_torch.ops import df64_spmv
    from superlu_dist_tpu_torch.ops.spmv import DeviceSpMV
    from superlu_dist_tpu_torch.precision import doubleword as dw
    dev = torch.device("cuda", torch.cuda.current_device())
    m = DeviceSpMV.build(a, device=dev, doubleword=True)
    m64 = DeviceSpMV.build(a, device=dev)
    n, w = m.ell_cols.shape
    rows = []
    for R in (1, 64):
        x = torch.from_numpy(np.random.default_rng(60 + R).standard_normal(
            (n, R))).to(dev)
        xh, xl = dw.split_f64_tensor(x)
        args = (m.ell_cols, m.ell_vals, m.ell_vals_lo, xh, xl)
        yk = df64_spmv.df64_ell_spmv(*args)
        yp = dw.df64_ell_spmv(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(k.view(torch.int32), p.view(torch.int32))
                   for k, p in zip(yk, yp))
        if not same:
            raise RuntimeError(f"K4 {label} nrhs {R}: not bitwise equal "
                               "to its plain version")
        _, rel64 = rel_err(dw.join_f64_tensor(*yk), m64.matvec(x))
        r = {"shape": [n, w, R], "operator": label, "dtype": "float32 pairs",
             "lane": "df64", "max_abs_err": 0.0, "bitwise": same,
             "rel_err_vs_f64_ell": rel64, "library_ms": None}
        if timed:
            tm = time_turns({
                "kernel": lambda: df64_spmv.df64_ell_spmv(*args),
                "plain": lambda: dw.df64_ell_spmv(*args),
                "f64_ell": lambda: m64.matvec(x)})
            flops, nbytes = df64_spmv.bound_work(n, w, R,
                                                 m.ell_cols.element_size())
            b_ms, b_by = bound_ms(flops, nbytes, "float32")
            r.update({"ms": tm["kernel"], "plain_ms": tm["plain"],
                      "f64_ell_ms": tm["f64_ell"], "bound_ms": b_ms,
                      "bound_by": b_by})
        log("[precision kernel df64_spmv] " + json.dumps(r))
        rows.append(r)
    return rows


def _ragged(k=12):
    """laplacian_3d(k) with row 7 emptied (ragged ELL rows, pad slots in
    every row): the card tests' operator."""
    import scipy.sparse as sp
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    m = laplacian_3d(k).to_scipy().tolil()
    m[7, :] = 0
    m = sp.csr_matrix(m)
    m.eliminate_zeros()
    return st.csr_from_scipy(m)


def precision_phase(a48):
    """Phase 13: (a) bfloat16 gssvx and the ladder, (b) the doubleword
    fused solver on laplacian_3d(48) and convection_diffusion_2d(200),
    then K4 against its plain version (and on a ragged operator) and
    the bfloat16 lanes of K1–K3 at phase 3's shapes."""
    import gc
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils import testmat
    recs, lanes = {}, {}
    plan48 = st.plan_factorization(a48)
    recs["bf16"], k4_bf16 = bf16_phase(a48, plan48, lanes)
    gc.collect()
    torch.cuda.empty_cache()
    recs["df64"] = [df64_phase("laplacian_3d(48)", a48, plan48)]
    gc.collect()
    torch.cuda.empty_cache()
    acd = testmat.convection_diffusion_2d(200)
    recs["df64"].append(df64_phase("convection_diffusion_2d(200)", acd,
                                   st.plan_factorization(acd)))
    gc.collect()
    torch.cuda.empty_cache()
    k4 = {"df64": k4_bf16 + sum(r["k4_launches"] for r in recs["df64"])}
    kres = kernel_checks(plan48, dtypes=("bfloat16",),
                         pairs=(("bfloat16", "float32"),
                                ("bfloat16", "float64")),
                         sweep=False)
    kres["df64_spmv"] = (check_df64(a48, "laplacian_3d(48)")
                         + check_df64(_ragged(), "ragged laplacian_3d(12)",
                                      timed=False))
    recs["kernels"] = kres
    return recs, kres, lanes, k4


# --------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------

def _tdt(name):
    import torch
    return getattr(torch, name)


def _ops_per_mac(dtype: str) -> int:
    """Real operations of one multiply-add: 2, or 8 in complex."""
    return 8 if dtype.startswith("complex") else 2


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
    it = _tdt(dtype).itemsize
    return bound_ms(panel_lu.k1_flops(N, mb, wb) * _ops_per_mac(dtype) / 2,
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


def _k1_input(N, mb, dtype, decouple=False):
    """K1's test fronts: seeded, diagonally dominant, with one
    exactly-tiny pivot planted in front 0 at (3, 3).  Row and column 3
    are decoupled from the columns before it; with `decouple` from the
    whole front, so the replaced pivot causes no element growth."""
    import torch
    tdt = _tdt(dtype)
    g = torch.Generator(device="cuda").manual_seed(N * 7919 + mb)
    F0 = torch.randn(N, mb, mb, generator=g, dtype=tdt, device="cuda")
    F0 += mb * torch.eye(mb, dtype=tdt, device="cuda")
    if decouple:
        F0[0, 3, :] = 0
        F0[0, :, 3] = 0
    else:
        F0[0, 3, :3] = 0
        F0[0, :3, 3] = 0
    F0[0, 3, 3] = 1e-30
    return F0


def k1_growth_spread(N, mb, wb, dtype="float64"):
    """On the coupled input (`_k1_input`), where the replaced pivot's
    row and column reach the rest of front 0 and its U grows: K1 against
    the plain version, beside the plain version at block 32 against
    block 64.  The two plain blockings are the same algorithm in
    another summation order, so their spread is the rounding the input
    itself leaves undetermined.  Reported, not gated."""
    import torch
    from superlu_dist_tpu_torch.ops import dense_lu, panel_lu
    F0 = _k1_input(N, mb, dtype)
    tdt = _tdt(dtype)
    thresh = float(torch.finfo(tdt).eps) ** 0.5 * float(F0.abs().max())
    K, P, P64 = F0.clone(), F0.clone(), F0.clone()
    panel_lu.partial_lu_batch(K, thresh, wb=wb)
    dense_lu.partial_lu_batch(P, thresh, wb=wb)
    dense_lu.partial_lu_batch(P64, thresh, wb=wb, nb=64)
    torch.cuda.synchronize()
    rec = {"shape": [N, mb, wb], "dtype": dtype,
           "kernel_vs_plain": rel_err(K, P)[1],
           "plain32_vs_plain64": rel_err(P64, P)[1],
           "growth": float(P.abs().max()) / float(F0.abs().max())}
    log("[arms kernel panel_lu growth] " + json.dumps(rec))
    return rec


def check_panel_lu(N, mb, wb, dtype, parent=None, decouple=False):
    import torch
    from superlu_dist_tpu_torch.ops import dense_lu, panel_lu
    tdt = _tdt(dtype)
    F0 = _k1_input(N, mb, dtype, decouple)
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
    if dtype == "bfloat16":
        excess = bf16_excess(F1, F2, k1_bf16_limit(F1, F2, wb))
        if not excess <= BF16_EXCESS_MAX:
            raise RuntimeError(f"panel_lu bfloat16 ({N},{mb},{wb}): "
                               f"|kernel - plain| reaches {excess:.3g} "
                               "of its per-element limit")
        tol = {"bf16_excess": excess, "max": BF16_EXCESS_MAX}
    else:
        tol = TOL[dtype]
        if not rel <= tol:
            raise RuntimeError(f"panel_lu {dtype} ({N},{mb},{wb}) rel "
                               f"err {rel:.3e} > {tol}")
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
            "rel_err": rel, "tol": tol, "ms": tm["kernel"],
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
    if dtype == "bfloat16":
        excess = bf16_excess(F1, F2, ea_bf16_limit(F0, upd, bucket))
        if not excess <= BF16_EXCESS_MAX:
            raise RuntimeError(f"ea_scatter bfloat16 rc_b={bucket.rc_b}: "
                               f"|kernel - plain| reaches {excess:.3g} "
                               "of its per-element limit")
        tol = {"bf16_excess": excess, "max": BF16_EXCESS_MAX}
    else:
        tol = TOL[dtype]
        if not rel <= tol:
            raise RuntimeError(f"ea_scatter {dtype} rc_b={bucket.rc_b} "
                               f"rel err {rel:.3e} > {tol}")
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
    # one add per live lane: 2 real operations in complex
    b_ms, b_by = bound_ms(live * (2.0 if dtype.startswith("complex")
                                  else 1.0), nbytes, dtype)
    return {"shape": [nrec, bucket.rc_b, g.mb], "dtype": dtype,
            "live_lanes": live, "max_abs_err": abs_err, "rel_err": rel,
            "tol": tol,
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
    tol = TOL[pdtype] if pdtype == xdtype else TOL[xdtype]
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
    elif pdtype == "bfloat16":
        # bfloat16 panels: the two torch.bmm on panels widened to the
        # right-hand side's type once, outside the timing
        Liw, L21w = Li.to(tx), L21c.to(tx)
        fns["library"] = lambda: torch.bmm(L21w, torch.bmm(Liw, xb))
    tm = time_turns(fns)
    ms, plain_ms, lib_ms = tm["kernel"], tm["plain"], tm.get("library")
    flops, nbytes = lsum.bound_work(t, wb, rt, R, Li.element_size(),
                                    xb.element_size())
    b_ms, b_by = bound_ms(flops * _ops_per_mac(xdtype) / 2, nbytes, xdtype)
    return {"shape": [t, wb, rt, R], "dtype": f"{pdtype}/{xdtype}",
            "lane": lsum.LANES[(tp, tx)],
            "max_abs_err": abs_err, "rel_err": rel, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "ms_over_plain": ms / plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


REAL = ("float32", "float64")
REAL_PAIRS = (("float32", "float32"), ("float64", "float64"),
              ("float32", "float64"))
COMPLEX = ("complex64", "complex128")
COMPLEX_PAIRS = (("complex64", "complex64"), ("complex128", "complex128"),
                 ("complex64", "complex128"))


def kernel_checks(plan, parent=None, dtypes=REAL, pairs=REAL_PAIRS,
                  k1_extra=None, many=True, sweep=True):
    """Each kernel against its plain version at shapes of `plan`'s
    schedule in `dtypes` (K3 in the panel / right-hand-side `pairs`),
    timed beside its bound and a library call; K1 also at `k1_extra`
    (default: a middle shape of the k=48 schedule) and, with `many`, at
    the group with the most fronts; with `sweep`, K1 alone at every
    shape of the schedule in float64."""
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
    picks = (g_freq, g_big, g_many) if many else (g_freq, g_big)
    shapes = list(dict.fromkeys([(g.n_loc, g.mb, g.wb) for g in picks]
                                + [k1_extra or K1_MIDDLE]))
    for N, mb, wb in shapes:
        for dt in dtypes:
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
    for g, b in ((pick_f,) if pick_b[1] is pick_f[1] else (pick_f, pick_b)):
        for dt in dtypes:
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
            for pd, xd in pairs:
                r = check_lsum(ts, g, gs, R, pd, xd)
                log("[kernel lsum] " + json.dumps(r))
                res["lsum"].append(r)
    # many right-hand sides are K3's open target: its time over the
    # plain version's at nrhs 64, in the widest type
    wide = f"{dtypes[-1]}/{dtypes[-1]}"
    log(f"[lsum nrhs 64] kernel ms / plain ms, {dtypes[-1]}: "
        + json.dumps({str(r["shape"]): round(r["ms_over_plain"], 3)
                      for r in res["lsum"]
                      if r["shape"][-1] == 64 and r["dtype"] == wide}))
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
    if sweep:
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


def _lane(name, r):
    """The lane a kernel-check row ran on."""
    if name == "lsum":
        return r["lane"]
    return {"float32": "f32", "float64": "f64", "complex64": "c64",
            "complex128": "c128", "bfloat16": "bf16"}[r["dtype"]]


def _arms_count(arms, name, lane=None):
    """Phase 12's launches of kernel `name`: on `lane`, or with None on
    its real lanes."""
    got = arms.get(name, {})
    if lane is not None:
        return int(got.get(lane, 0))
    return int(sum(c for ln, c in got.items() if not ln.startswith("c")))


def kernels_line(res, launches, gate_launches, driver_launches, cres,
                 clanes, arms):
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
            "replaces": repl,
            "launches": int(launches[name] + gate_launches[name]
                            + driver_launches[name]
                            + _arms_count(arms, name)),
            "launches_main": int(launches[name]),
            "launches_gate": int(gate_launches[name]),
            "launches_drivers": int(driver_launches[name]),
            "launches_arms": _arms_count(arms, name),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"]})
    # the complex lanes: launches in phase 11's drives (a) and (b), the
    # headline row at the largest bound (one right-hand side for lsum)
    for name, (src, repl) in KERNELS.items():
        for lane in COMPLEX_LANES[name]:
            rows = [r for r in cres[name] if _lane(name, r) == lane]
            head = max((r for r in rows
                        if name != "lsum" or r["shape"][-1] == 1),
                       key=lambda r: r["bound_ms"])
            out.append({
                "name": f"{name}_{lane}", "route": "cuda", "source": src,
                "replaces": repl,
                "launches": int(clanes[name][lane])
                + _arms_count(arms, name, lane),
                "launches_arms": _arms_count(arms, name, lane),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "shape": head["shape"], "dtype": head["dtype"]})
    return {"kernels": out}


# phase 13's lanes of K1–K3 (bfloat16 factors)
PRECISION_LANES = {"panel_lu": ("bf16",), "ea_scatter": ("bf16",),
                   "lsum": ("bf16_f32", "bf16_f64")}


def precision_rows(kres, lanes, k4):
    """The kernels line's rows of phase 13: the bfloat16 lanes of K1–K3
    (launches: phase 13 (a)'s and (a2)'s drives) and K4 (launches: (a2)
    and (b)'s doubleword calls), each with its headline timing row (the
    largest bound; one right-hand side for lsum)."""
    out = []
    for name, (src, repl) in KERNELS.items():
        for lane in PRECISION_LANES[name]:
            rows = [r for r in kres[name] if _lane(name, r) == lane]
            head = max((r for r in rows
                        if name != "lsum" or r["shape"][-1] == 1),
                       key=lambda r: r["bound_ms"])
            n = int(lanes.get(name, {}).get(lane, 0))
            if n <= 0:
                raise RuntimeError(f"{name} lane {lane} was never launched "
                                   "on phase 13's drives")
            out.append({
                "name": f"{name}_{lane}", "route": "cuda", "source": src,
                "replaces": repl, "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                **({"update_library_ms": head["update_library_ms"]}
                   if name == "panel_lu" else {}),
                "shape": head["shape"], "dtype": head["dtype"]})
    timed = [r for r in kres["df64_spmv"] if "ms" in r]
    head = max(timed, key=lambda r: r["bound_ms"])
    if k4["df64"] <= 0:
        raise RuntimeError("K4 was never launched on phase 13's drives")
    out.append({
        "name": "df64_spmv", "route": "cuda",
        "source": "superlu_dist_tpu_torch/csrc/df64_spmv.cu",
        "replaces": "superlu_dist_tpu/precision/doubleword.py:228",
        "replaces_note": "no TPU kernel: the reference's plain-jnp lane",
        "launches": int(k4["df64"]),
        "max_abs_err": max(r["max_abs_err"] for r in kres["df64_spmv"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "f64_ell_ms": head["f64_ell_ms"],
        "shape": head["shape"], "dtype": head["dtype"]})
    return out


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
    log(f"build: K1-K4 built in {b['seconds']:.1f} s "
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

    # the numerical-trust layer (the condition gate on for this phase)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    report["gate"], gate_launches = gate_phase(a48)

    # the command lines, the readers and the host backend
    gc.collect()
    torch.cuda.empty_cache()
    report["drivers"], driver_launches = drivers_phase()

    # native complex systems
    gc.collect()
    torch.cuda.empty_cache()
    t_cplx = time.perf_counter()
    report["complex"], cres, clanes = complex_phase()
    report["complex_kernels"] = cres
    report["complex_wall_s"] = time.perf_counter() - t_cplx
    log(f"[complex] phase wall {report['complex_wall_s']:.1f} s, "
        "launches per lane " + json.dumps(clanes))

    # the core's last arms: level merging, the legacy sweep, pair
    # storage, each flag set for its drives only
    gc.collect()
    torch.cuda.empty_cache()
    t_arms = time.perf_counter()
    report["arms"], arms_lanes = arms_phase()
    report["arms_wall_s"] = time.perf_counter() - t_arms
    log(f"[arms] phase wall {report['arms_wall_s']:.1f} s, launches per "
        "lane " + json.dumps(arms_lanes))

    # the precision subsystem: bfloat16 factors and the ladder, the
    # doubleword fused solver (K4), the bfloat16 lanes
    gc.collect()
    torch.cuda.empty_cache()
    t_prec = time.perf_counter()
    report["precision"], pres, plane, k4 = precision_phase(a48)
    report["precision_wall_s"] = time.perf_counter() - t_prec
    log(f"[precision] phase wall {report['precision_wall_s']:.1f} s, "
        "bfloat16 launches per lane " + json.dumps(plane)
        + f", K4 launches {k4['df64']}")

    report["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    # 14. the summary lines, the contract line last
    line = kernels_line(res, rec["launches"], gate_launches,
                        driver_launches, cres, clanes, arms_lanes)
    line["kernels"] += precision_rows(pres, plane, k4)
    log(json.dumps(line))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
