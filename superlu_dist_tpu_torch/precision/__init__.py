"""precision/ — the mixed-precision subsystem.

  * `doubleword` — two-float "df64" arithmetic in fp32 torch operations
    (Dekker/Knuth error-free transformations): add/mul/dot/axpy and
    the df64 lanes of the ELL/COO refinement-residual SpMV (the ELL
    lane's kernel is K4, ops/df64_spmv.py).
  * `policy` — `PrecisionPolicy` (factor/solve dtype, residual mode,
    target accuracy) threaded through Options, and the escalation
    ladder (bfloat16 → float32 → float64).
"""

from .doubleword import (DF64_EPS, df64_coo_spmv, df64_ell_spmv,
                         df_add, df_add_f, df_axpy, df_dot, df_mul,
                         df_mul_f, df_neg, df_sub, df_sum, join_f64,
                         quick_two_sum, split_f64, two_prod, two_sum)
from .policy import (RESIDUAL_MODES, PrecisionPolicy, ResidualMode,
                     classify_trigger, ladder, ladder_policies,
                     lower_rungs, next_factor_dtype,
                     resolve_residual_mode)

__all__ = [
    "DF64_EPS", "PrecisionPolicy", "RESIDUAL_MODES", "ResidualMode",
    "classify_trigger", "df64_coo_spmv", "df64_ell_spmv", "df_add",
    "df_add_f", "df_axpy", "df_dot", "df_mul", "df_mul_f", "df_neg",
    "df_sub", "df_sum", "join_f64", "ladder", "ladder_policies",
    "lower_rungs", "next_factor_dtype", "quick_two_sum",
    "resolve_residual_mode",
    "split_f64", "two_prod", "two_sum",
]
