"""Triangular-solve parity: identical factors (the JAX package's,
carried across with interop.lu_from_arrays) solved by the JAX
package's solve_device / solve_device_trans and by the port's packed
merged sweep, NOTRANS and TRANS, at nrhs 1 and 8.  Solutions agree to
1e-10 relative in float64 and 1e-4 in float32."""

import numpy as np
import pytest

from torch_port_util import (TOL, jax_factor_arrays, jax_factorization,
                             ported_plan, rel_maxnorm)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("name,dtype", [("lap3d6", np.float64),
                                        ("lap3d6", np.float32),
                                        ("convdiff12", np.float64)])
def test_solve_matches_reference(name, dtype, trans):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, jlu, _ = jax_factorization(name, dtype)
    pt = ported_plan(pj)
    lu = interop.lu_from_arrays(pt, jax_factor_arrays(jlu), dtype, "cpu")
    rng = np.random.default_rng(11)
    jsolve = jb.solve_device_trans if trans else jb.solve_device
    tsolve = tb.solve_device_trans if trans else tb.solve_device
    for nrhs in (1, 8):
        b = rng.standard_normal((pj.n, nrhs)).astype(dtype)
        if nrhs == 1:
            b = b[:, 0]
        ref = jsolve(jlu, b)
        got = tsolve(lu, b)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert rel_maxnorm(got, ref) < TOL[np.dtype(dtype)], nrhs


def test_mixed_precision_solve_promotes():
    """float32 factors against a float64 right-hand side (the
    refinement residual) solve in float64 in both packages."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, jlu, _ = jax_factorization("lap3d6", np.float32)
    lu = interop.lu_from_arrays(ported_plan(pj), jax_factor_arrays(jlu),
                                np.float32, "cpu")
    b = np.random.default_rng(2).standard_normal((pj.n, 3))
    ref = jb.solve_device(jlu, b)
    got = tb.solve_device(lu, b)
    assert got.dtype == ref.dtype == np.float64
    assert rel_maxnorm(got, ref) < 1e-10


def test_port_factors_solve_the_system():
    """The port's own factors (not the carried ones) through the
    packed sweep: residual at rounding level for both trans lanes."""
    import scipy.sparse as sp
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, _, scaled = jax_factorization("convdiff12", np.float64)
    pt = ported_plan(pj)
    lu = tb.factorize_device(pt, scaled, device="cpu")
    # M = Pf_r · (Dr A Dc) · Pf_cᵀ in factor ordering
    n = pt.n
    M = sp.coo_matrix((scaled, (pt.final_row[pt.coo_rows],
                                pt.final_col[pt.coo_cols])),
                      shape=(n, n)).tocsr()
    b = np.random.default_rng(5).standard_normal((n, 2))
    for trans, solve in ((False, tb.solve_device),
                         (True, tb.solve_device_trans)):
        x = solve(lu, b)
        Mx = (M.T if trans else M) @ x
        assert rel_maxnorm(Mx, b) < 1e-12, trans
