"""Registry of every `SLU_`-prefixed environment flag the port reads.

The port keeps its own, much shorter table: only the knobs its main
path reads.  The accessors below are the package's only way to read
an environment variable, and they refuse names the table does not
document, so an undocumented knob fails at its first read.

Convention: boolean flags take "1"/"0"; numeric flags parse int/float;
unset means the documented default.  SUPERLU_*-prefixed knobs are the
reference's sp_ienv analog chain and live on Options fields
(options.py), not here.
"""

from __future__ import annotations

import os

# flag name -> one-line description (scope: where it is read)
FLAGS: dict[str, str] = {
    # --- kernel build (ops/_cuda.py) ---
    "SLU_KERNEL_BUILD_DIR": "directory the CUDA kernels are built into (default superlu_dist_tpu_torch/_build)",
    # --- compiled-program layer (ops/batched.py, ops/trisolve.py;
    # the reference's switches, names and defaults) ---
    "SLU_STAGED": "staged factorization (one CUDA graph per merged segment): 1 on, 0 off, auto (default) on past SLU_STAGED_MIN_GROUPS groups",
    "SLU_STAGED_MIN_GROUPS": "group count above which SLU_STAGED=auto stages (default 96)",
    "SLU_FACTOR_MERGE_CELLS": "front cells (n_loc*mb*mb) at or below which a factor group joins a merged segment (default 65536; 0: one group per segment)",
    "SLU_FACTOR_SEG_CELLS": "front-cell budget of one merged factor segment (default 1048576)",
    "SLU_TRISOLVE_MERGE_CELLS": "panel cells (trim*mb*wb) at or below which a solve group joins a merged segment (default 65536)",
    "SLU_TRISOLVE_SEG_CELLS": "panel-cell budget of one merged solve segment (default 1048576)",
    "SLU_TRISOLVE": "auto|merged|legacy solve arm (default auto = merged): merged = the packed lsum sweep (kernel K3 on the forward step); legacy = the level sweep (index gather, batched products, index_add_ into one solution array; no K3)",
    # --- level merging (ops/batched.build_schedule; the reference's
    # names and defaults) ---
    "SLU_LEVEL_MERGE": "1 = coalesce each etree level's bucket groups into fewer padded groups, cost-bounded by SLU_LEVEL_MERGE_LIMIT; 0 (default) = one group per (wb, mb) bucket",
    "SLU_LEVEL_MERGE_LIMIT": "max padded/original front-cell ratio a level merge may reach (default 1.5; values below 1 read as 1)",
    # --- complex storage (models/gssvx.py, ops/batched.py; the
    # reference's name) ---
    "SLU_COMPLEX_PAIR": "1 = factor complex systems on stacked real/imag planes (pair storage): the handle's flats are (2, N) real planes, extend-add runs plane by plane on K2's real lane and the partial LU on K1's complex lane; the handle's storage, not the flag, decides how it is solved; unset or 0 (default) = native complex storage",
    # --- residual SpMV layout (ops/spmv.py) ---
    "SLU_SPMV_LAYOUT": "auto|ell|coo residual SpMV layout (ell = scatter-free padded rows)",
    "SLU_SPMV_ELL_WASTE": "max ELL padding ratio over true nnz before falling back to COO (default 4)",
    # --- mixed precision (precision/, options.py; the reference's
    # names and defaults) ---
    "SLU_PREC_RESIDUAL": "auto|plain|doubleword|fp64 default Options.residual_mode: how the refinement residual accumulates (doubleword = two-float fp32 df64 pairs on the fused device loop, kernel K4; the host loop uses native f64 either way)",
    "SLU_PREC_LADDER": "comma dtype list overriding the escalation ladder (default bfloat16,float32,float64; sorted by eps, climbed one rung per failed refinement contract; each rung re-pays one factorization)",
    # --- numerical trust layer (numerics/, models/gssvx.py; the
    # reference's names and defaults) ---
    "SLU_COND_ESTIMATE": "1 = Hager-Higham rcond estimate after every gssvx factorization (numerics/gscon.py): at most 2*SLU_COND_MAXITER+2 refinement-free solves on the resident factors, no extra factorization; off (default) = rcond stays lazy (ensure_rcond) and the condition policy never engages",
    "SLU_COND_MAXITER": "Hager-Higham iteration cap per rcond estimate (default 5; each iteration is one forward + one transpose solve)",
    "SLU_COND_FLOOR": "rcond refusal floor: an estimate at or below it raises SingularMatrixError (default 0 = auto: eps(refine_dtype)); only engaged when an estimate exists",
    "SLU_COND_POLICY": "serve|stamp|refuse for ill-conditioned (above-floor) keys: serve = silent, stamp (default) = the result is a PerturbedResult, refuse = SingularMatrixError; the floor refusal applies in every mode",
    "SLU_COND_STAMP": "ill-conditioned threshold on rcond (default 0 = auto: sqrt(eps(refine_dtype))); below it the policy mode engages and the escalation ladder climbs a rung before the first solve",
}

EXTERNAL_PREFIXES: tuple = ("SUPERLU_",)


def _known(name: str) -> str:
    if name in FLAGS or name.startswith(EXTERNAL_PREFIXES):
        return name
    raise KeyError(
        f"undocumented env flag {name!r}: document it in "
        "superlu_dist_tpu_torch/flags.py FLAGS before reading it")


def env_opt(name: str) -> str | None:
    """Raw documented-flag read: the value, or None when unset."""
    return os.environ.get(_known(name))


def env_str(name: str, default: str = "") -> str:
    """Documented-flag read with a default ('' unless given)."""
    return os.environ.get(_known(name), default)


def env_int(name: str, default: int) -> int:
    """Int-valued documented flag; empty/unset -> default."""
    v = os.environ.get(_known(name))
    return int(v) if v else default


def env_float(name: str, default: float) -> float:
    """Float-valued documented flag; empty/unset -> default."""
    v = os.environ.get(_known(name))
    return float(v) if v else default
