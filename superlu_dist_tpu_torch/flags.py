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
    # --- residual SpMV layout (ops/spmv.py) ---
    "SLU_SPMV_LAYOUT": "auto|ell|coo residual SpMV layout (ell = scatter-free padded rows)",
    "SLU_SPMV_ELL_WASTE": "max ELL padding ratio over true nnz before falling back to COO (default 4)",
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
