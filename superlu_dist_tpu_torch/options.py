"""Solver options.

Analog of the reference's option system:
`superlu_dist_options_t` (SRC/superlu_defs.h:716-755), the enum constants
(SRC/superlu_enum_consts.h:29-90) and `set_default_options_dist`
(SRC/util.c:203-238).  One dataclass with typed enums replaces the C
struct + int-coded constants; defaults mirror the reference's where they
make sense on an accelerator.
"""

from __future__ import annotations

import dataclasses
import enum

from . import flags as _flags


class YesNo(enum.Enum):
    NO = 0
    YES = 1

    def __bool__(self) -> bool:
        return self is YesNo.YES


class Fact(enum.Enum):
    """Factorization reuse ladder (SRC/superlu_defs.h:577-598).

    The reference's checkpoint/resume analog (SURVEY.md §5.4): PDE apps
    re-solve with the same sparsity pattern (or the same pattern *and*
    row permutation) many times; each rung reuses more of the cached
    plan/factorization.
    """

    DOFACT = 0                  # factor from scratch
    SAME_PATTERN = 1            # reuse col perm + etree + symbolic plan
    SAME_PATTERN_SAME_ROWPERM = 2  # also reuse row perm + scalings
    FACTORED = 3                # reuse the numeric factorization; just solve


class RowPerm(enum.Enum):
    """Static-pivoting row permutation (SRC/superlu_enum_consts.h:32)."""

    NOROWPERM = 0
    LARGE_DIAG_MC64 = 1     # serial max-product bipartite matching (MC64 job=5)
    LARGE_DIAG_HWPM = 2     # parallel heavy-weight perfect matching analog
    MY_PERMR = 3            # user-supplied perm_r


class ColPerm(enum.Enum):
    """Fill-reducing column permutation (SRC/superlu_enum_consts.h:33-41)."""

    NATURAL = 0
    MMD_ATA = 1             # minimum degree on A^T A
    MMD_AT_PLUS_A = 2       # minimum degree on A^T + A
    COLAMD = 3
    METIS_AT_PLUS_A = 4     # nested dissection on A^T + A
    PARMETIS = 5
    MY_PERMC = 6            # user-supplied perm_c
    RCM = 7                 # reverse Cuthill-McKee (this build's extra)
    AMD = 8                 # approximate minimum degree (native in this build)


class IterRefine(enum.Enum):
    """Iterative refinement mode (SRC/superlu_enum_consts.h:34)."""

    NOREFINE = 0
    SLU_SINGLE = 1          # residual accumulated in working precision
    SLU_DOUBLE = 2          # residual accumulated in f64 (psgsrfs_d2 analog)


class Trans(enum.Enum):
    NOTRANS = 0
    TRANS = 1
    CONJ = 2


# Per-request solve knobs: merged onto a reused handle by the FACTORED
# rung (models/gssvx.py gssvx); they never change what factors are
# computed.
SOLVE_TIME_FIELDS = ("trans", "iter_refine", "refine_dtype",
                     "max_refine_steps", "residual_mode",
                     "solve_dtype")


def merge_solve_options(base: "Options", request: "Options") -> "Options":
    """`base` (the options describing stored factors) with the
    request's SOLVE_TIME_FIELDS — the FACTORED-rung merge."""
    return base.replace(**{f: getattr(request, f)
                           for f in SOLVE_TIME_FIELDS})


def _env_int(name: str, default: int) -> int:
    """Env-var override, mirroring sp_ienv_dist's SUPERLU_* chain
    (SRC/sp_ienv.c:60-146) — routed through the flags.py gateway,
    whose EXTERNAL_PREFIXES allowance admits SUPERLU_* names."""
    return _flags.env_int(name, default)


@dataclasses.dataclass
class Options:
    """All solver knobs; defaults follow set_default_options_dist
    (SRC/util.c:203-238) adapted to a batched accelerator.
    """

    fact: Fact = Fact.DOFACT
    equil: YesNo = YesNo.YES
    row_perm: RowPerm = RowPerm.LARGE_DIAG_MC64
    col_perm: ColPerm = ColPerm.MMD_AT_PLUS_A
    replace_tiny_pivot: YesNo = YesNo.YES
    iter_refine: IterRefine = IterRefine.SLU_DOUBLE
    trans: Trans = Trans.NOTRANS

    # --- supernode / scheduling tunables (sp_ienv_dist analogs) ---
    # sp_ienv(2): relaxed-supernode max size (SRC/sp_ienv.c, SUPERLU_RELAX)
    relax: int = dataclasses.field(default_factory=lambda: _env_int("SUPERLU_RELAX", 32))
    # sp_ienv(3): maximum supernode width (SUPERLU_MAXSUP; MAX_SUPER_SIZE=512)
    max_super: int = dataclasses.field(default_factory=lambda: _env_int("SUPERLU_MAXSUP", 128))
    # supernode amalgamation (plan/symbolic.py amalgamate): merge
    # contiguous parent/child supernodes while total true flops grow at
    # most (1+amalg_tau)×; fewer, bigger fronts trade cheap dense flops
    # for fewer sequential level steps.  0 disables.  The reference has
    # no analog (it relaxes only at the leaves) — this knob exists
    # because the latency/flop trade is inverted on an accelerator.
    amalg_tau: float = dataclasses.field(
        default_factory=lambda: float(_env_int("SUPERLU_AMALG_TAU_PCT",
                                               100)) / 100.0)
    # width cap for amalgamated supernodes (MAX_SUPER_SIZE analog)
    amalg_cap: int = dataclasses.field(
        default_factory=lambda: _env_int("SUPERLU_AMALG_CAP", 512))
    # symbolic-factorization worker threads (symbfact_dist analog,
    # SRC/psymbfact.c:150): 0 = auto, 1 = serial, k = exactly k
    symb_threads: int = dataclasses.field(
        default_factory=lambda: _env_int("SUPERLU_SYMB_THREADS", 0))
    # nested-dissection recursion-half threads (the ParMETIS-slot
    # parallel ordering).  Default 1: the single-threaded native pass
    # is already ~80x the numpy oracle and threads only pay off on
    # much larger graphs than the bench family.
    nd_threads: int = dataclasses.field(
        default_factory=lambda: _env_int("SUPERLU_ND_THREADS", 1))

    # --- precision strategy (the psgssvx_d2 mixed mode, SRC/psgssvx_d2.c:516,
    # generalized: factor in `factor_dtype`, accumulate residuals in
    # `refine_dtype`) ---
    factor_dtype: str = "float64"
    refine_dtype: str = "float64"
    # Refinement-residual accumulation: "auto" (plain under
    # SLU_SINGLE, refine_dtype under SLU_DOUBLE), "plain", "fp64", or
    # "doubleword" (fp32 (hi, lo) pairs on the fused device loop; the
    # host loop accumulates it in native float64).  The default comes
    # from SLU_PREC_RESIDUAL.  Resolved only through
    # precision.policy.resolve_residual_mode.
    residual_mode: str = dataclasses.field(
        default_factory=lambda: _flags.env_str(
            "SLU_PREC_RESIDUAL", "auto") or "auto")
    # Triangular-sweep RHS dtype: None promotes the right-hand side
    # against the factor dtype (models/gssvx.py solve); an explicit "float32" keeps an fp32 pipeline end-to-end
    # instead of silently paying fp64 sweeps for an fp64 RHS.
    solve_dtype: str | None = None

    # --- iterative refinement controls ---
    max_refine_steps: int = 8
    # Precision escalation: when a low-precision factor's refinement
    # stagnates above sqrt(eps(refine_dtype)) — the cond·eps_factor
    # contract failed — gssvx refactors once at refine_dtype and
    # resolves.  The safety net the psgssvx_d2 strategy leaves to the
    # caller (SURVEY.md §2.6); here it is automatic because GESP has
    # no numerical pivoting to fall back on mid-factor.
    escalate: YesNo = dataclasses.field(
        default_factory=lambda: YesNo(
            1 if _env_int("SUPERLU_ESCALATE", 1) else 0))

    # --- bucketing (replaces ragged supernode shapes; SURVEY.md §7) ---
    width_buckets: tuple = (8, 16, 32, 64, 128, 256, 512)
    front_buckets: tuple = (16, 32, 64, 128, 256, 384, 512, 768, 1024,
                            1536, 2048, 3072, 4096, 6144, 8192)
    # refit the bucket grids to this pattern's supernode population
    # before the final plan (plan/autotune.py; sp_ienv tuning analog).
    # Costs one extra symbolic pass, pays back in padded-flop waste.
    autotune: bool = dataclasses.field(
        default_factory=lambda: bool(_env_int("SUPERLU_AUTOTUNE", 0)))

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        """print_options_dist analog (SRC/util.c:242): one line per
        knob, enums by name."""
        lines = ["** Options **"]
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            v = v.name if isinstance(v, enum.Enum) else v
            lines.append(f"  {f.name:<22s} {v}")
        return "\n".join(lines)
