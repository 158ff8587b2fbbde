"""Test/benchmark matrix generators.

Analog of the reference's generated 5-point Laplacians used by its TEST
sweep (TEST/CMakeLists.txt:13 NVAL 9 19) and the shipped Harwell-Boeing
samples (EXAMPLE/g20.rua etc.) — here generated so tests need no data
files."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..sparse import CSRMatrix, csr_from_scipy


def laplacian_2d(k: int, dtype=np.float64) -> CSRMatrix:
    """5-point Laplacian on a k×k grid (n = k²), the pdtest generator
    analog."""
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    a = sp.kronsum(t, t, format="csr").astype(dtype)
    return csr_from_scipy(a)


def laplacian_3d(k: int, dtype=np.float64) -> CSRMatrix:
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    a = sp.kronsum(sp.kronsum(t, t), t, format="csr").astype(dtype)
    return csr_from_scipy(a)


def random_unsymmetric(n: int, density: float = 0.01, seed: int = 0,
                       dtype=np.float64) -> CSRMatrix:
    """Random sparse nonsingular matrix with weak diagonal (exercises
    the static-pivoting row permutation)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng,
                  data_rvs=lambda size: rng.standard_normal(size))
    # ensure structural nonsingularity via a random permutation diagonal
    perm = rng.permutation(n)
    d = sp.coo_matrix((rng.standard_normal(n) + 3.0 * np.sign(
        rng.standard_normal(n)), (np.arange(n), perm)), shape=(n, n))
    m = (a + d).tocsr().astype(dtype)
    return csr_from_scipy(m)


def convection_diffusion_2d(k: int, wind: float = 20.0,
                            dtype=np.float64) -> CSRMatrix:
    """Unsymmetric 2D convection-diffusion (upwind), a realistic
    unsymmetric PDE matrix."""
    h = 1.0 / (k + 1)
    main = sp.diags([-1.0, 2.0 + wind * h, -1.0 - wind * h], [-1, 0, 1],
                    shape=(k, k))
    lap = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    a = (sp.kron(sp.eye(k), main) + sp.kron(lap, sp.eye(k))).tocsr()
    return csr_from_scipy(a.astype(dtype))


def helmholtz_2d(k: int, shift: complex = 0.5 + 0.5j,
                 dtype=np.complex128) -> CSRMatrix:
    """Complex shifted 2D Laplacian (Helmholtz-type), the canonical
    complex test problem — analog of the reference's z-precision
    inputs (EXAMPLE/cg20.cua)."""
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    a = (sp.kronsum(t, t) - shift * sp.eye(k * k)).tocsr().astype(dtype)
    return csr_from_scipy(a)
