"""superlu_dist_tpu_torch — the sparse LU solver on PyTorch and CUDA.

A port of `superlu_dist_tpu` (the JAX package beside it, which stays
the reference) to PyTorch on an NVIDIA Hopper card: sparse LU with
static pivoting (GESP), a supernodal multifrontal factorization
executed level by level in padded bucket batches, a packed merged
triangular solve, and iterative refinement with mixed precision
(bfloat16 or float32 factors refined to float64 on the host, or on the
card through double-word fp32 residuals, precision/).  The three kernels the reference wrote in
Pallas — the front partial LU, the extend-add scatter and the fused
forward lsum — are CUDA C++ kernels here (ops/panel_lu.py,
ops/ea_scatter.py, ops/lsum.py, sources under csrc/), each beside its
plain PyTorch version.

The module names follow the reference package so a reader can find
each counterpart.  This package imports neither jax nor the reference.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a card and without that explicit request they
raise — they never fall back to the CPU on their own.

Numerics: a float32 product in TF32 keeps about three decimal digits,
which breaks the refinement contract (cond·eps_factor < 1) of the
float32-factor mode, so importing the package turns TF32 off for both
cuBLAS and cuDNN and pins float32 matmul precision to "highest".
float64 is the working dtype (Options.factor_dtype defaults to it), and
every tensor the package creates names its dtype explicitly: torch's
process-wide default stays float32 and untouched.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .options import (  # noqa: E402
    ColPerm,
    Fact,
    IterRefine,
    Options,
    RowPerm,
    Trans,
    YesNo,
)
from .utils.stats import Stats  # noqa: E402
from .sparse import CSRMatrix, csr_from_coo, csr_from_scipy  # noqa: E402
from .device import resolve_device  # noqa: E402
from .plan.plan import FactorPlan  # noqa: E402
from .models.gssvx import (  # noqa: E402
    LUFactorization,
    factorize,
    get_diag_u,
    gssvx,
    plan_factorization,
    query_space,
    solve,
    warm_solve,
)
from .utils.io import read_matrix  # noqa: E402
from .precision import PrecisionPolicy, ResidualMode  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ColPerm",
    "Fact",
    "IterRefine",
    "Options",
    "RowPerm",
    "Trans",
    "YesNo",
    "Stats",
    "CSRMatrix",
    "csr_from_coo",
    "csr_from_scipy",
    "FactorPlan",
    "LUFactorization",
    "PrecisionPolicy",
    "ResidualMode",
    "factorize",
    "get_diag_u",
    "gssvx",
    "plan_factorization",
    "query_space",
    "read_matrix",
    "resolve_device",
    "solve",
    "warm_solve",
    "__version__",
]
