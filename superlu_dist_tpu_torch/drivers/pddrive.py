"""pddrive — solve A·X = B from a matrix file (EXAMPLE/pddrive.c:51).

Reads Harwell-Boeing (.rua/.cua), Rutherford-Boeing (.rb), MatrixMarket
(.mtx), triples (.dat/.datnh) or raw binary (.bin) by filename postfix
like the reference's dcreate_matrix_postfix, manufactures a known
solution (dGenXtrue_dist/dFillRHS_dist analog), runs the full gssvx
pipeline and prints the inf-norm error (EXAMPLE/pddrive.c:323
pdinf_norm_error), the relative residual and the PStatPrint-style
phase report.  Exit code 0 when the relative residual is below 1e-6.

    python -m superlu_dist_tpu_torch.drivers.pddrive g20.rua    # on the card
    python -m superlu_dist_tpu_torch.drivers.pddrive --device cpu g20.rua
    python -m superlu_dist_tpu_torch.drivers.pddrive --fused --dtype float32 A.mtx

The solve runs on the CUDA card unless `--device cpu` asks for the
plain PyTorch versions on the host, or `--backend host` for the numpy
multifrontal backend; without a card and without either it exits with
the no-device message.  The -r/-c/-d process-grid flags and --stats
are accepted for the reference's command lines, and refused above one
device: multi-GPU is ROADMAP queue 1 item 15.  A complex matrix (a
`.cua` or complex `.mtx` file, say) factors in complex128, or in the
complex dtype of `--dtype` (float32 -> complex64), and its manufactured
solution is complex; under SLU_COMPLEX_PAIR=1 it factors on pair
storage (stacked real/imag planes, ops/batched.py), and the output
names the storage.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

from .. import Options, gssvx
from ..device import NoCudaDeviceError, dtype_info, resolve_device
from ..models.gssvx import (_HOST_BF16, _should_escalate_fused,
                            effective_factor_dtype, plan_factorization)
from ..numerics import health
from ..ops.batched import _pair_mode, make_fused_solver
from ..options import ColPerm, IterRefine, RowPerm, Trans
from ..precision.policy import classify_trigger, next_factor_dtype
from ..utils.io import read_matrix
from ..utils.stats import Stats

_MULTI_GPU_TODO = ("-r/-c/-d with a product above 1 and --stats select "
                   "the distributed solve, which is not ported yet "
                   "(ROADMAP queue 1 item 15, multi-GPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pddrive",
        description="sparse LU solve of A·X=B on a CUDA card")
    p.add_argument("matrix", help="matrix file (.rua/.cua/.rb/.mtx/"
                                  ".dat/.datnh/.bin)")
    p.add_argument("-r", "--nprow", type=int, default=1,
                   help="process grid rows (multi-GPU, not ported)")
    p.add_argument("-c", "--npcol", type=int, default=1,
                   help="process grid cols (multi-GPU, not ported)")
    p.add_argument("-d", "--npdep", type=int, default=1,
                   help="grid depth (multi-GPU, not ported)")
    p.add_argument("-s", "--nrhs", type=int, default=1)
    p.add_argument("--dtype", default=None,
                   help="factor dtype (default float64; float32 or "
                        "bfloat16 for the mixed-precision strategy, "
                        "which climbs the escalation ladder when the "
                        "refinement contract fails)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "torch", "host"],
                   help="auto = torch (the device path); host = the "
                        "numpy multifrontal backend on the CPU")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                        "runs the plain PyTorch versions on the host)")
    p.add_argument("--fused", action="store_true",
                   help="run the fused solver (factor, solve and "
                        "refinement on the device)")
    p.add_argument("--colperm", default="METIS_AT_PLUS_A",
                   choices=[m.name for m in ColPerm])
    p.add_argument("--rowperm", default="LARGE_DIAG_MC64",
                   choices=[m.name for m in RowPerm])
    p.add_argument("--refine", default="SLU_DOUBLE",
                   choices=[m.name for m in IterRefine])
    p.add_argument("--trans", default="NOTRANS",
                   choices=[m.name for m in Trans])
    p.add_argument("--no-equil", action="store_true")
    p.add_argument("--autotune", action="store_true",
                   help="refit padding bucket grids to this pattern "
                        "(one extra symbolic pass)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the solve into "
                        "DIR (pddrive_trace.json, chrome trace format)")
    p.add_argument("--stats", action="store_true",
                   help="collective traffic of a distributed run "
                        "(multi-GPU, not ported)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="echo the effective options "
                        "(print_options_dist analog)")
    return p


def _refuse(msg: str) -> int:
    print(f"pddrive: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.nprow * args.npcol * args.npdep > 1 or args.stats:
        return _refuse(_MULTI_GPU_TODO)
    if args.fused and args.backend == "host":
        return _refuse("--fused runs on the device; drop --backend host")
    dev = None
    if args.backend != "host":
        # the device first: without a card nothing is read or planned
        try:
            dev = resolve_device(args.device)
        except NoCudaDeviceError as e:
            return _refuse(str(e))
    a = read_matrix(args.matrix)
    n = a.n
    if not args.quiet:
        print(f"matrix: {args.matrix}  n={n}  nnz={a.nnz}  "
              f"dtype={a.dtype}")

    complex_sys = np.issubdtype(a.dtype, np.complexfloating)
    fdt = args.dtype or ("complex128" if complex_sys else "float64")
    try:
        eff = effective_factor_dtype(a.dtype, fdt).name
    except TypeError as e:
        return _refuse(str(e))
    if args.backend == "host" and eff == "bfloat16":
        return _refuse(_HOST_BF16)
    if eff != fdt:
        if not args.quiet:
            print(f"complex matrix: factor dtype mapped to {eff}")
        fdt = eff
    if complex_sys and not args.quiet:
        print("complex storage: "
              + ("pair planes" if _pair_mode(fdt) else "native"))

    opts = Options(
        factor_dtype=fdt,
        equil=not args.no_equil,
        col_perm=ColPerm[args.colperm],
        row_perm=RowPerm[args.rowperm],
        iter_refine=IterRefine[args.refine],
        trans=Trans[args.trans],
        # only override when the flag is given so the SUPERLU_AUTOTUNE
        # env default (options.py) still applies without it
        **({"autotune": True} if args.autotune else {}),
    )
    if args.fused and opts.trans != Trans.NOTRANS:
        return _refuse("the fused solver is NOTRANS-only; drop --fused "
                       "for transpose solves")

    if args.verbose:
        print(opts.describe())

    # manufactured solution (dGenXtrue_dist / dFillRHS_dist)
    rng = np.random.default_rng(args.seed)
    xtrue = rng.standard_normal((n, args.nrhs))
    if complex_sys:
        xtrue = xtrue + 1j * rng.standard_normal((n, args.nrhs))
    asp = a.to_scipy()
    op = {Trans.NOTRANS: asp, Trans.TRANS: asp.T,
          Trans.CONJ: asp.conj().T}[opts.trans]
    b = op @ xtrue

    stats = Stats()
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev is not None and dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

    with prof:
        if args.fused:
            x = _solve_fused(a, b, opts, stats, dev)
        else:
            x, _, stats = gssvx(opts, a, b, stats=stats,
                                backend=args.backend, device=dev)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile,
                                              "pddrive_trace.json"))

    x = np.asarray(x)
    err = np.max(np.abs(x - xtrue)) / max(np.max(np.abs(xtrue)), 1e-300)
    if not args.quiet:
        print(stats.report())
    print(f"inf-norm error: {err:.3e}")
    relres = (np.linalg.norm(op @ x - b)
              / max(np.linalg.norm(b), 1e-300))
    print(f"relative residual: {relres:.3e}")
    return 0 if relres < 1e-6 else 1


def _solve_fused(a, b, opts, stats, dev):
    """make_fused_solver with the reference's escalation ladder: when
    the low-precision factor fails its refinement contract, rebuild the
    fused solver one precision rung up on the same plan and rerun,
    under its own FACT_ESC phase."""
    plan = plan_factorization(a, opts, stats=stats, device=dev)

    def run(dtype_name, phase):
        # a rung of the ladder names a precision; a complex system
        # factors in the complex dtype of that precision
        fdt = effective_factor_dtype(a.dtype, dtype_name)
        step = make_fused_solver(plan, dtype=fdt)
        with stats.timer(phase):
            x, berr, steps, tiny, _ = step(a.data, b)
            berr = float(berr)      # the last value the step computes
        stats.add_ops(phase, plan.factor_flops)
        stats.berr = berr
        stats.refine_steps += int(steps)
        stats.tiny_pivots += int(tiny)
        return x

    x = run(opts.factor_dtype, "FACT")
    cur = opts.factor_dtype
    while _should_escalate_fused(opts.replace(factor_dtype=cur), stats):
        nxt = next_factor_dtype(cur, ceiling=opts.refine_dtype)
        if nxt is None:
            break
        stats.escalations += 1
        # a finite berr with step budget left means the loop quit
        # because berr stopped halving; no handle exists here, so the
        # pivot-growth probe is unavailable by construction
        stalled = (np.isfinite(stats.berr)
                   and stats.refine_steps < opts.max_refine_steps)
        health.record("escalation", berr=stats.berr, factor_dtype=cur,
                      refine_dtype=opts.refine_dtype, to_dtype=nxt,
                      trigger=classify_trigger(
                          stats.berr, stalled=stalled,
                          factor_eps=dtype_info(cur).eps))
        x = run(nxt, "FACT_ESC")
        cur = nxt
    return x.cpu().numpy()


if __name__ == "__main__":
    sys.exit(main())
