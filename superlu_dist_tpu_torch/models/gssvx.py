"""Expert driver: the pdgssvx analog (SRC/pdgssvx.c:506).

`gssvx(options, A, B)` runs the full pipeline — equilibrate, static
pivoting row perm, fill-reducing col perm, symbolic plan (host),
numeric factorization and triangular solves (device), iterative
refinement (host residuals) — and returns X, the factorization handle
and statistics.  `factorize`/`solve` expose the two halves for the
Fact reuse ladder (SamePattern / SamePattern_SameRowPerm / FACTORED,
SRC/superlu_defs.h:577-598):

    plan = plan_factorization(A, opts)        # once per pattern
    lu   = factorize(A, plan=plan)            # per value set
    x    = solve(lu, b)                       # per right-hand side

Backends: "torch" (the level-batched factorization and packed solve
on the device, K1–K3 on the card) and "host" (ops/ref_multifrontal.py,
the numpy multifrontal oracle).  `backend="auto"` is "torch", always;
"host" is only ever an explicit request.  Every torch-backend entry
point runs on the CUDA device unless the caller passes
`device="cpu"`; with no card and no explicit request it raises
(device.NoCudaDeviceError).  The host backend needs no card and
resolves no device.

The numerical-trust layer rides every call: each factorization
carries its perturbation ledger (numerics/ledger.py), a result that
rode perturbed or ill-conditioned factors comes back stamped
(PerturbedResult), and with SLU_COND_ESTIMATE=1 the condition gate
estimates rcond off the resident factors before the first solve and
refuses a numerically singular system (numerics/gscon.py,
numerics/policy.py).

Complex systems (complex64/complex128) run natively: a complex matrix
factors in the complex dtype of its factor precision
(`effective_factor_dtype`), a real matrix with a complex right-hand
side keeps its real factors and solves in complex, and CONJ is the
TRANS pipeline between two conjugations.  Under SLU_COMPLEX_PAIR=1 a
complex system factors on pair storage ((2, N) real planes,
ops/batched.py); the handle's storage decides how it is solved, so a
pair handle stays one after the flag is unset.

Not ported yet (ROADMAP queue 1): the "dist" backend and `grid=`
(item 15), health events and memory watermarks (item 14;
numerics/health.record is their seam).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ..device import DTypeInfo, dtype_info, resolve_device, solve_dtype
from ..numerics import health
from ..numerics.errors import InvalidInputError
from ..numerics.gscon import ensure_rcond
from ..numerics.ledger import (PerturbationLedger, build_ledger,
                               stamp_perturbed)
from ..numerics.policy import ConditionPolicy, cond_estimate_enabled
from ..ops import batched, ref_multifrontal
from ..options import ColPerm, Fact, IterRefine, Options, Trans
from ..plan import plan as plan_mod
from ..plan.plan import FactorPlan
from ..sparse import CSRMatrix
from ..utils.stats import Stats

_DIST_TODO = ("the dist backend and grid= (mesh execution over several "
              "devices) are not ported yet (ROADMAP queue 1 item 15, "
              "multi-GPU)")
_BACKENDS = ("auto", "torch", "host")
_HOST_BF16 = ("the host backend factors in numpy, which has no bfloat16 "
              "without the ml_dtypes package (not a dependency of the "
              "port): factor bfloat16 on the torch backend")


@dataclasses.dataclass
class LUFactorization:
    """Factorization handle: plan + numeric factors (LUstruct analog,
    SRC/superlu_ddefs.h:266-271): device factors for the torch
    backend, host panels for the host backend."""
    plan: FactorPlan
    device_lu: Optional[batched.StagedLU | batched.DeviceLU] = None
    backend: str = "torch"
    host_lu: Optional[ref_multifrontal.HostLU] = None
    a: Optional[CSRMatrix] = None         # kept for refinement residuals
    stats: Optional[Stats] = None
    options: Optional[Options] = None     # effective numeric options
    # refinement operands (A, |A| in refine precision), built once per
    # handle; dataclasses.replace copies share the same container
    refine_cache: dict = dataclasses.field(default_factory=dict,
                                           repr=False, compare=False)
    cache_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # numerical-trust fields (numerics/): the Hager-Higham rcond
    # estimate (None until numerics.gscon.ensure_rcond caches it;
    # replace copies carry a computed value forward) and the tiny-pivot
    # perturbation ledger factorize() builds
    rcond: Optional[float] = None
    ledger: Optional[PerturbationLedger] = None

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def device(self) -> torch.device:
        if self.backend == "host":
            return torch.device("cpu")
        return self.device_lu.device

    @property
    def effective_options(self) -> Options:
        return self.options or self.plan.options


def effective_factor_dtype(a_dtype, factor_dtype) -> DTypeInfo:
    """The dtype the factors are computed in: a complex system forces a
    complex factor dtype of matching precision (bfloat16 and float32 ->
    complex64, float64 -> complex128), as the reference's
    np.promote_types maps it; a real system keeps `factor_dtype`."""
    fdt = dtype_info(factor_dtype)
    if dtype_info(a_dtype).is_complex and not fdt.is_complex:
        fdt = dtype_info(torch.promote_types(fdt.torch, torch.complex64))
    return fdt


def resolve_backend(backend: str, grid=None) -> str:
    """"auto" is "torch", always (the reference falls back to its host
    backend when its device module fails to import; the port never
    chooses the CPU for the caller).  "dist" and any `grid=` are
    refused until the multi-GPU item lands."""
    if backend == "dist" or grid is not None:
        raise ValueError(_DIST_TODO)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    return "torch" if backend == "auto" else backend


def _plan(a, options, stats, dev, user_perm_r=None, user_perm_c=None):
    """The host plan, bound to `dev` (None for the host backend: such a
    plan names no device, and a torch factorization on it resolves its
    own)."""
    plan = plan_mod.plan_factorization(a, options, stats=stats,
                                       user_perm_r=user_perm_r,
                                       user_perm_c=user_perm_c)
    plan.device = None if dev is None else str(dev)
    return plan


def plan_factorization(a: CSRMatrix, options: Options | None = None,
                       stats: Stats | None = None, device=None,
                       user_perm_r: np.ndarray | None = None,
                       user_perm_c: np.ndarray | None = None
                       ) -> FactorPlan:
    """The host plan for `a`, bound to the device its factorizations
    will run on."""
    return _plan(a, options, stats, resolve_device(device), user_perm_r,
                 user_perm_c)


def factorize(a: CSRMatrix, options: Options | None = None,
              plan: FactorPlan | None = None,
              stats: Stats | None = None, device=None,
              user_perm_r: np.ndarray | None = None,
              user_perm_c: np.ndarray | None = None,
              backend: str = "auto", grid=None,
              _phase: str = "FACT") -> LUFactorization:
    # caller's options win (numeric knobs may differ from the cached
    # plan's); fall back to the plan's when none are given
    if options is None:
        options = plan.options if plan is not None else Options()
    stats = stats if stats is not None else Stats()
    backend = resolve_backend(backend, grid)
    dev = None
    if backend == "torch":
        if device is None and plan is not None:
            device = plan.device
        dev = resolve_device(device)
    fdt = effective_factor_dtype(a.dtype, options.factor_dtype)
    if fdt.name != options.factor_dtype:
        options = options.replace(factor_dtype=fdt.name)
    if plan is None:
        plan = _plan(a, options, stats, dev, user_perm_r, user_perm_c)
    scaled = plan.scaled_values(a)
    if backend == "host":
        if fdt.name == "bfloat16":
            raise ValueError(_HOST_BF16)
        with stats.timer(_phase):
            host_lu = ref_multifrontal.factorize_host(plan, scaled,
                                                      dtype=fdt.numpy)
        tiny = host_lu.tiny_pivots
        lu = LUFactorization(plan=plan, backend="host", host_lu=host_lu,
                             a=a, stats=stats, options=options)
    else:
        with stats.timer("SCHED"):
            # the level schedule and its device index sets, built once
            # per plan (SAME_PATTERN_SAME_ROWPERM and escalation reuse
            # them)
            batched.get_schedule(plan).to_device(dev)
        with stats.timer(_phase):
            device_lu = batched.factorize_device(plan, scaled, dtype=fdt,
                                                 device=dev)
        tiny = int(device_lu.tiny_pivots)
        lu = LUFactorization(plan=plan, device_lu=device_lu, a=a,
                             stats=stats, options=options)
    stats.tiny_pivots += tiny
    stats.add_ops(_phase, plan.factor_flops)
    stats.lu_nnz = plan.lu_nnz()
    stats.lu_bytes = stats.lu_nnz * fdt.itemsize
    stats.note_factor_event(tiny_pivots=tiny, dtype=options.factor_dtype)
    # the perturbation ledger: free on a clean factorization (the O(n)
    # diagonal gather runs only when a replaced pivot was counted)
    lu.ledger = build_ledger(lu)
    health.record("factor", tiny_pivots=tiny, dtype=options.factor_dtype,
                  perturbation=(lu.ledger.to_dict() if lu.ledger.perturbed
                                else None))
    return lu


def _solve_factored(lu: LUFactorization, b_factor_order: np.ndarray):
    """Triangular solves in factor ordering/scaling."""
    if lu.backend == "host":
        return ref_multifrontal.solve_host(lu.host_lu, b_factor_order)
    return batched.solve_device(lu.device_lu, b_factor_order)


def _solve_factored_trans(lu: LUFactorization,
                          b_factor_order: np.ndarray):
    """Mᵀ·y = b in factor ordering (forward Uᵀ, backward Lᵀ)."""
    if lu.backend == "host":
        return ref_multifrontal.solve_host_trans(lu.host_lu,
                                                 b_factor_order)
    return batched.solve_device_trans(lu.device_lu, b_factor_order)


def solve(lu: LUFactorization, b: np.ndarray,
          stats: Stats | None = None) -> np.ndarray:
    """Solve A·x = b for one or many right-hand sides (b: (n,) or
    (n, nrhs)).  Applies scalings/permutations, the factored solves,
    and iterative refinement per options (pdgstrs + pdgsrfs analog,
    SRC/pdgstrs.c:1035, SRC/pdgsrfs.c:124)."""
    plan = lu.plan
    stats = stats or lu.stats or Stats()
    options = lu.effective_options
    b = np.asarray(b)
    if b.shape[0] != plan.n:
        raise ValueError(
            f"b has {b.shape[0]} rows but the matrix is {plan.n}×{plan.n}")
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    if options.solve_dtype is not None:
        # pin the sweep precision instead of letting the caller's RHS
        # dtype promote the whole solve (an fp32 pipeline must not pay
        # fp64 sweeps because a client sent a float64 buffer); the
        # realness is the system's, the precision the option's
        sdt = dtype_info(options.solve_dtype).working.torch
        if np.issubdtype(bb.dtype, np.complexfloating):
            sdt = torch.promote_types(sdt, torch.complex64)
        bb = bb.astype(dtype_info(sdt).numpy)

    if options.trans == Trans.CONJ:
        # (Aᴴ)⁻¹·b = conj((Aᵀ)⁻¹·conj(b)): the TRANS pipeline,
        # refinement included, on the conjugated system (for a real
        # system the conjugations are no-ops)
        lu_t = dataclasses.replace(
            lu, options=options.replace(trans=Trans.TRANS))
        x = np.conj(solve(lu_t, np.conj(bb), stats=stats))
        return x[:, 0] if squeeze else x

    if options.trans == Trans.NOTRANS:
        # M = Pf_r·Dr·A·Dc·Pf_cᵀ:  b' = Pf_r·Dr·b ; x = Dc·Pf_cᵀ·y
        def to_factor_rhs(v):
            scaled = v * plan.row_scale[:, None]
            out = np.empty_like(scaled)
            out[plan.final_row] = scaled
            return out

        def from_factor_sol(y):
            out = y[plan.final_col]
            return out * plan.col_scale[:, None]

        solver = _solve_factored
    else:
        # (Aᵀ)⁻¹ = Dr·Pf_rᵀ·M⁻ᵀ·Pf_c·Dc: the roles of (row perm, row
        # scale) and (col perm, col scale) swap around the Mᵀ solve
        def to_factor_rhs(v):
            scaled = v * plan.col_scale[:, None]
            out = np.empty_like(scaled)
            out[plan.final_col] = scaled
            return out

        def from_factor_sol(y):
            out = y[plan.final_row]
            return out * plan.row_scale[:, None]

        solver = _solve_factored_trans

    with stats.timer("SOLVE"):
        x = from_factor_sol(solver(lu, to_factor_rhs(bb)))

    if options.iter_refine != IterRefine.NOREFINE and lu.a is not None:
        from .refine import iterative_refine
        with stats.timer("REFINE"):
            x, berr, steps, stalled = iterative_refine(
                lu, bb, x, solver, to_factor_rhs, from_factor_sol,
                trans=(options.trans == Trans.TRANS))
        stats.berr = berr
        stats.refine_steps += steps
        stats.refine_stalled = stalled

    return x[:, 0] if squeeze else x


def solve_rhs_dtype(lu: LUFactorization) -> np.dtype:
    """The dtype a plain float64 right-hand side has after the solve
    path's promotion against the factors: the solve graphs' operand
    dtype, which warm_solve must use to capture the graphs live
    traffic replays.  An explicit Options.solve_dtype replaces the
    float64 the promotion otherwise assumes of the right-hand side.
    A bfloat16 factor's sweeps run in at least float32."""
    opts = lu.effective_options
    rhs = (opts.solve_dtype if opts.solve_dtype is not None
           else "float64")
    return dtype_info(solve_dtype(opts.factor_dtype, rhs)).numpy


def warm_solve(lu: LUFactorization, nrhs_widths=(1,),
               dtype=None) -> None:
    """Capture the solve graphs for the given right-hand-side widths
    with zero solves (a zero right-hand side is exact under the sweeps
    and runs the very programs live traffic replays)."""
    dt = np.dtype(dtype) if dtype is not None else solve_rhs_dtype(lu)
    for k in nrhs_widths:
        solve(lu, np.zeros((lu.n, int(k)), dtype=dt))


def get_diag_u(lu: LUFactorization) -> np.ndarray:
    """Diagonal of U in FACTOR column order (pdGetDiagU analog,
    SRC/pdGetDiagU.c): diag(U)[final_col[j]] is original column j's
    pivot.  Gathered on the device: only the n pivots cross to the
    host, never the U slab."""
    plan = lu.plan
    fp = plan.frontal
    xsup = fp.sym.part.xsup
    if lu.backend == "host":
        out = np.empty(plan.n, dtype=dtype_info(
            lu.effective_options.factor_dtype).numpy)
        for s, hu in enumerate(lu.host_lu.U):
            w = int(fp.w[s])
            out[int(xsup[s]):int(xsup[s]) + w] = np.diagonal(hu[:w, :w])
        return out
    d = lu.device_lu
    vals, dst = [], []
    for g, (_, U, _, _) in zip(d.schedule.groups, d.panels):
        # a (wb, mb) row-major panel's diagonal is base + i·(mb+1)
        idx = torch.as_tensor(np.concatenate([
            b * g.wb * g.mb + np.arange(int(fp.w[s])) * (g.mb + 1)
            for b, s in zip(g.sup_pos, g.sup_ids)]), device=U.device)
        # pair storage: the pivots' two planes, decoded after the gather
        vals.append(torch.complex(U[0, idx], U[1, idx]) if U.dim() == 2
                    else U[idx])
        dst += [int(xsup[s]) + np.arange(int(fp.w[s]))
                for s in g.sup_ids]
    # a bfloat16 factor's pivots come back in float32 (exact)
    info = dtype_info(d.dtype)
    out = np.empty(plan.n, dtype=info.working.numpy)
    out[np.concatenate(dst)] = torch.cat(vals).cpu().to(
        info.working.torch).numpy()
    return out


def _factor_tensors(d) -> list:
    """A handle's device factors in a deterministic order: a StagedLU's
    per-group panels, a DeviceLU's four slabs."""
    return ([a for p in d.panels for a in p]
            if isinstance(d, batched.StagedLU) else list(d.flats()))


def _host_panels(h: ref_multifrontal.HostLU) -> list:
    """A host handle's panels: every L, then U, Linv, Uinv."""
    return [p for side in (h.L, h.U, h.Linv, h.Uinv) for p in side]


def factor_arrays(lu: LUFactorization) -> list:
    """The numeric factor payload as host arrays (an O(factor bytes)
    transfer, for once-per-factorization save and validate paths,
    never a solve); a host handle's panels are returned as they are."""
    if lu.backend == "host":
        return _host_panels(lu.host_lu)
    # bfloat16 panels come back as float32 (exact)
    host = dtype_info(lu.device_lu.dtype).working.torch
    return [a.cpu().to(host).numpy()
            for a in _factor_tensors(lu.device_lu)]


def factors_finite(lu: LUFactorization) -> bool:
    """True when every factor entry is finite: a NaN/Inf-poisoned factor
    gives silently wrong solves under GESP (no runtime pivoting to
    catch it).  Checked on the device, one sync."""
    if lu.backend == "host":
        return all(bool(np.isfinite(p).all())
                   for p in _host_panels(lu.host_lu))
    return bool(torch.stack([torch.isfinite(a).all() for a in
                             _factor_tensors(lu.device_lu)]).all())


def query_space(lu: LUFactorization) -> dict:
    """LU storage accounting (dQuerySpace_dist analog,
    SRC/superlu_ddefs.h:616): true nnz(L+U) and the bytes the factors
    hold (padded panels on the device, unpadded ones on the host)."""
    itemsize = dtype_info(lu.effective_options.factor_dtype).itemsize
    nnz = lu.plan.lu_nnz()
    d = lu.device_lu
    if lu.backend == "host":
        held = sum(p.nbytes for p in _host_panels(lu.host_lu))
    elif isinstance(d, batched.StagedLU):
        held = d.held_bytes()
    else:
        held = sum(f.numel() * f.element_size() for f in d.flats())
    return {"lu_nnz": nnz, "lu_bytes": nnz * itemsize,
            "held_bytes": int(held)}


def gssvx(options: Options | None, a: CSRMatrix, b: np.ndarray,
          stats: Stats | None = None, backend: str = "auto",
          lu: LUFactorization | None = None, device=None,
          user_perm_r: np.ndarray | None = None,
          user_perm_c: np.ndarray | None = None, grid=None):
    """One-call driver.  Returns (x, lu, stats).  Pass `lu` with
    options.fact=FACTORED to reuse a prior factorization, or with
    options.fact=SAME_PATTERN* to re-factor new values reusing the
    plan.  user_perm_r/user_perm_c feed RowPerm.MY_PERMR /
    ColPerm.MY_PERMC.  `backend` is "auto" (= "torch"), "torch" or
    "host"; the host backend resolves no device."""
    options = options or Options()
    stats = stats if stats is not None else Stats()
    backend = resolve_backend(backend, grid)
    dev = None
    if backend == "torch":
        if device is None and lu is not None and lu.backend == "torch":
            device = lu.device
        dev = resolve_device(device)
    _validate_system(a, b)
    return _gssvx_impl(options, a, b, stats, lu, dev, backend,
                       user_perm_r, user_perm_c)


def _validate_system(a, b) -> None:
    """Typed front-door rejection of malformed systems
    (InvalidInputError, a ValueError)."""
    n = int(getattr(a, "n", 0))
    if n == 0:
        raise InvalidInputError("empty system: A is 0x0")
    b = np.asarray(b)
    if b.ndim not in (1, 2) or b.shape[0] != n:
        raise InvalidInputError(
            f"b has shape {b.shape} but the matrix is {n}x{n}")
    if b.size == 0:
        raise InvalidInputError("empty right-hand side: b has 0 "
                                "columns")
    vals = getattr(a, "data", None)
    if vals is not None and not bool(np.isfinite(vals).all()):
        raise InvalidInputError(
            "non-finite entries in A: a NaN/Inf value would poison "
            "the factors (GESP has no runtime pivoting to catch it); "
            "refused before paying a factorization")
    if not bool(np.isfinite(b).all()):
        raise InvalidInputError("non-finite entries in b")


def _gssvx_impl(options, a, b, stats, lu, dev, backend, user_perm_r,
                user_perm_c):
    if options.fact in (Fact.FACTORED, Fact.SAME_PATTERN,
                        Fact.SAME_PATTERN_SAME_ROWPERM) and lu is None:
        raise ValueError(f"options.fact={options.fact.name} requires "
                         "an existing lu")
    if options.fact == Fact.FACTORED:
        # honor the caller's solve-time knobs on the reused handle;
        # factorization-describing knobs keep describing the factors
        from ..options import merge_solve_options
        lu = dataclasses.replace(
            lu, options=merge_solve_options(lu.effective_options,
                                            options))
    elif options.fact == Fact.SAME_PATTERN:
        # reuse only the fill-reducing column permutation; recompute
        # equilibration, row perm and the symbolic plan for the new
        # values (SRC/superlu_defs.h:584-588)
        opts2 = options.replace(col_perm=ColPerm.MY_PERMC)
        plan = _plan(a, opts2, stats, dev, user_perm_c=lu.plan.perm_c)
        lu = factorize(a, opts2, plan=plan, stats=stats, device=dev,
                       backend=backend)
    elif options.fact == Fact.SAME_PATTERN_SAME_ROWPERM:
        # reuse perms, scalings and the whole symbolic plan; refresh
        # numeric values only
        lu = factorize(a, options, plan=lu.plan, stats=stats,
                       device=dev, backend=backend)
    else:
        lu = factorize(a, options, stats=stats, device=dev,
                       user_perm_r=user_perm_r, user_perm_c=user_perm_c,
                       backend=backend)
    # condition gate BEFORE the first solve: refuse numerically
    # singular factors (typed, never a garbage solve) and pre-climb the
    # ladder for ill-conditioned keys under SLU_COND_ESTIMATE=1
    lu = _condition_gate(options, a, lu, stats, dev, backend)
    x = solve(lu, b, stats=stats)
    # precision-escalation ladder (precision/policy.py): when a
    # low-precision factor fails its refinement contract
    # (cond(A)·eps_factor ≥ 1: berr stagnates far above the refine
    # class), re-factor one rung up; the plan is value-identical
    # across rungs, so it is reused outright.  Each climb is a health
    # event labelled with the signal that fired.  Terminates:
    # eps(factor) strictly decreases toward the refine_dtype ceiling.
    from ..precision.policy import next_factor_dtype
    while True:
        trigger = _escalation_trigger(options, lu, stats)
        if trigger is None:
            break
        cur = lu.effective_options.factor_dtype
        nxt = next_factor_dtype(cur, ceiling=options.refine_dtype)
        if nxt is None:
            break
        stats.escalations += 1
        health.record("escalation", berr=stats.berr, factor_dtype=cur,
                      refine_dtype=options.refine_dtype, to_dtype=nxt,
                      trigger=trigger)
        lu = factorize(a, options.replace(factor_dtype=nxt),
                       plan=lu.plan, stats=stats, device=dev,
                       backend=backend, _phase="FACT_ESC")
        x = solve(lu, b, stats=stats)
    # re-gate after a berr-driven escalation: the rcond of the
    # ESCALATED handle is the one the policy and the stamp describe;
    # free when none ran (the rcond is cached on the handle)
    lu2 = _condition_gate(options, a, lu, stats, dev, backend)
    if lu2 is not lu:
        lu = lu2
        x = solve(lu, b, stats=stats)
    return _stamp_result(x, lu, options), lu, stats


def _condition_gate(options, a, lu, stats, dev, backend):
    """Condition estimation and policy enforcement after a
    factorization (SLU_COND_ESTIMATE=1): estimate rcond off the
    resident factors, refuse numerically singular systems with
    SingularMatrixError, and climb the precision ladder one rung BEFORE
    the first solve when the key classifies ill-conditioned.
    Terminates at the ladder ceiling like the berr ladder."""
    if not cond_estimate_enabled():
        return lu
    from ..precision.policy import next_factor_dtype
    policy = ConditionPolicy.from_env()
    while True:
        rcond = ensure_rcond(lu)
        stats.rcond = rcond
        cls = policy.enforce(rcond, options.refine_dtype)
        if (cls != "ill" or options.fact == Fact.FACTORED
                or not options.escalate):
            return lu
        cur = lu.effective_options.factor_dtype
        nxt = next_factor_dtype(cur, ceiling=options.refine_dtype)
        if nxt is None:
            return lu
        stats.escalations += 1
        health.record("escalation", berr=stats.berr, factor_dtype=cur,
                      refine_dtype=options.refine_dtype, to_dtype=nxt,
                      trigger="ill_conditioned")
        lu = factorize(a, options.replace(factor_dtype=nxt),
                       plan=lu.plan, stats=stats, device=dev,
                       backend=backend, _phase="FACT_ESC")


def _stamp_result(x, lu, options):
    """Label solutions that rode perturbed or ill-conditioned factors
    (numerics/ledger.PerturbedResult, a zero-copy view); a clean
    well-conditioned solve returns a plain ndarray."""
    led = lu.ledger
    rcond = lu.rcond
    ill = False
    if rcond is not None:
        policy = ConditionPolicy.from_env()
        ill = (policy.mode == "stamp"
               and policy.classify(rcond, options.refine_dtype) == "ill")
    if (led is not None and led.perturbed) or ill:
        return stamp_perturbed(x, ledger=led, rcond=rcond)
    return x


def _escalation_trigger(options: Options, lu: LUFactorization,
                        stats: Stats):
    """None when the refinement contract held; otherwise the
    health-signal label (precision/policy.classify_trigger) justifying
    one ladder rung up.  The pivot-growth probe gathers diag(U) to the
    host (O(n)), paid only once the berr gate has decided to
    escalate."""
    if not _should_escalate(options, lu, stats):
        return None
    from ..precision.policy import classify_trigger
    f_eps = dtype_info(lu.effective_options.factor_dtype).eps
    return classify_trigger(stats.berr, stalled=stats.refine_stalled,
                            pivot_growth=health.pivot_growth(lu),
                            factor_eps=f_eps)


def _should_escalate(options: Options, lu: LUFactorization,
                     stats: Stats) -> bool:
    if options.fact == Fact.FACTORED:
        # solve-only rung: never silently re-pay a factorization
        return False
    return _escalation_core(options, lu.effective_options.factor_dtype,
                            stats)


def _should_escalate_fused(options: Options, stats: Stats) -> bool:
    """Escalation test for the fused solver (pddrive --fused), which
    always factors fresh at options.factor_dtype."""
    return _escalation_core(options, options.factor_dtype, stats)


# refinement-contract class boundary: converged means berr within 6
# bits of eps(refine_dtype); a stalled factor sits orders above it
_ESC_BERR_SLACK = 64.0


def _escalation_core(options: Options, factor_dtype: str,
                     stats: Stats) -> bool:
    if not options.escalate:
        return False
    if options.iter_refine == IterRefine.NOREFINE:
        return False
    f_eps = dtype_info(factor_dtype).eps
    r_eps = dtype_info(options.refine_dtype).eps
    if f_eps <= r_eps:            # nothing higher to escalate to
        return False
    # a NaN/Inf berr (overflowed low-precision factor) must escalate
    return not (stats.berr <= _ESC_BERR_SLACK * r_eps)
