"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*).

Both packages see the same inputs: matrices from each package's own
generators (identical numpy code), and dense data made with numpy from
a seed.  State crosses from the JAX package to the port only as plain
arrays (`flatten` below → superlu_dist_tpu_torch.interop).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

# tier-1 runs several xdist workers on one host
torch.set_num_threads(2)

# (generator name, args) of the small parity matrices
MATRICES = {
    "lap3d6": ("laplacian_3d", (6,), {}),
    "convdiff12": ("convection_diffusion_2d", (12,), {}),
    "randunsym200": ("random_unsymmetric", (200,), {"density": 0.02}),
}


def matrix_pair(name):
    """The same matrix from the JAX package's and the port's
    generators (identical numpy code)."""
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    fn, args, kw = MATRICES[name]
    aj = getattr(jtm, fn)(*args, **kw)
    at = getattr(ttm, fn)(*args, **kw)
    assert np.array_equal(aj.data, at.data)
    return aj, at


def flatten(obj):
    """A dataclass tree as plain data: dicts by field name, enum
    members by name, lists for sequences, numpy arrays as they are."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: flatten(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [flatten(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def jax_plan(aj):
    """A fresh JAX plan (fresh per call: the JAX schedule and phase
    caches hang off the plan object)."""
    from superlu_dist_tpu import Options
    from superlu_dist_tpu.plan.plan import plan_factorization
    return plan_factorization(aj, Options())


def ported_plan(jplan):
    """The JAX plan carried into the port."""
    from superlu_dist_tpu_torch import interop
    return interop.plan_from_arrays(flatten(jplan), device="cpu")


def jax_factor_arrays(jlu):
    """A JAX factor handle's numeric payload as numpy: per-group
    (L, U, Li, Ui) flats for StagedLU, the four flats for DeviceLU."""
    if hasattr(jlu, "panels"):
        return [tuple(np.asarray(a) for a in p) for p in jlu.panels]
    return [np.asarray(a) for a in (jlu.L_flat, jlu.U_flat,
                                    jlu.Li_flat, jlu.Ui_flat)]


def rel_maxnorm(a, b) -> float:
    """max|a − b| / max|b| (0 when both vanish)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    s = float(np.max(np.abs(b))) if b.size else 0.0
    d = float(np.max(np.abs(a - b))) if b.size else 0.0
    return d / s if s else d


TOL = {np.dtype(np.float64): 1e-10, np.dtype(np.float32): 1e-4}


_JAX_LU = {}


def jax_factorization(name, dtype):
    """(JAX plan, JAX factor handle, scaled values) of a parity
    matrix, cached per process: the factor and solve tests share it."""
    key = (name, np.dtype(dtype).str)
    if key not in _JAX_LU:
        from superlu_dist_tpu.ops import batched as jb
        aj, _ = matrix_pair(name)
        pj = jax_plan(aj)
        scaled = pj.scaled_values(aj)
        jlu = jb.factorize_device(pj, scaled, dtype=np.dtype(dtype))
        _JAX_LU[key] = (pj, jlu, scaled)
    return _JAX_LU[key]
