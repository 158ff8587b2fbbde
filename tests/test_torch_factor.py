"""Numeric factorization parity: the same plan (carried across with
interop.plan_from_arrays) factored by the JAX package's
factorize_device and by the port (plain versions on the CPU).  L, U,
Li and Ui agree per group in the max-norm — to 1e-10 relative in
float64 and 1e-4 in float32, since the frameworks reduce the GEMMs in
different orders — and the tiny-pivot counts are equal."""

import numpy as np
import pytest

from torch_port_util import (MATRICES, TOL, jax_factor_arrays,
                             jax_factorization, ported_plan, rel_maxnorm)


@pytest.mark.parametrize("name,dtype", [
    (name, np.float64) for name in sorted(MATRICES)] + [
    ("lap3d6", np.float32), ("convdiff12", np.float32)])
def test_factor_matches_reference(name, dtype):
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, jlu, scaled = jax_factorization(name, dtype)
    pt = ported_plan(pj)
    lu = tb.factorize_device(pt, scaled, dtype=dtype, device="cpu")
    assert lu.tiny_pivots == int(jlu.tiny_pivots)
    # the reference's factors in the port's per-group layout
    ref = interop.lu_from_arrays(pt, jax_factor_arrays(jlu), dtype,
                                 "cpu")
    tol = TOL[np.dtype(dtype)]
    assert len(lu.panels) == len(ref.panels) == len(lu.schedule.groups)
    for gi, (pg, rg) in enumerate(zip(lu.panels, ref.panels)):
        for what, a, b in zip(("L", "U", "Li", "Ui"), pg, rg):
            assert a.dtype == b.dtype and a.shape == b.shape
            err = rel_maxnorm(a.numpy(), b.numpy())
            assert err < tol, (gi, what, err)


def test_factor_flats_round_trip():
    """StagedLU.flats() is the reference's DeviceLU slab layout, and
    interop accepts either form."""
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, jlu, scaled = jax_factorization("lap3d6", np.float64)
    pt = ported_plan(pj)
    lu = tb.factorize_device(pt, scaled, device="cpu")
    flats = [f.numpy() for f in lu.flats()]
    sched = lu.schedule
    assert [len(f) for f in flats] == [sched.L_total, sched.U_total,
                                       sched.Li_total, sched.Ui_total]
    back = interop.lu_from_arrays(pt, flats, np.float64, "cpu")
    for pa, pb in zip(lu.panels, back.panels):
        for a, b in zip(pa, pb):
            assert np.array_equal(a.numpy(), b.numpy())


def test_zero_pivot_raises_like_reference():
    """replace_tiny_pivot=NO with an exactly singular leading block:
    both packages raise ZeroDivisionError."""
    import scipy.sparse as sp
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.options import RowPerm, YesNo
    A = sp.csr_matrix(np.array([[1.0, 1.0, 0.0],
                                [1.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0]]))
    b = np.ones(3)
    opts = st.Options(replace_tiny_pivot=YesNo.NO, equil=YesNo.NO,
                      row_perm=RowPerm.NOROWPERM)
    with pytest.raises(ZeroDivisionError):
        st.gssvx(opts, st.csr_from_scipy(A), b, device="cpu")
    jopts = jslu.Options(replace_tiny_pivot=jslu.YesNo.NO,
                         equil=jslu.YesNo.NO,
                         row_perm=jslu.RowPerm.NOROWPERM)
    with pytest.raises(ZeroDivisionError):
        jslu.gssvx(jopts, jslu.csr_from_scipy(A), b)


@pytest.mark.parametrize("k", [48, 128, 192, 512])
def test_triangular_inverses_match_reference(k):
    """unit_lower_inverse / upper_inverse (the DiagInv preparation)
    against the JAX package's, past the Newton leaf size too, where
    the port runs the recursion level by level."""
    import jax.numpy as jnp
    import torch
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu_torch.ops import dense_lu as td
    rng = np.random.default_rng(k)
    A = rng.standard_normal((3, k, k)) / k
    L = np.tril(A, -1) + np.eye(k)
    U = np.triu(A, 1) + np.diag(1.0 + rng.random(k))
    for got, ref, M in ((td.unit_lower_inverse(torch.from_numpy(L)),
                         jd.unit_lower_inverse(jnp.asarray(L)), L),
                        (td.upper_inverse(torch.from_numpy(U)),
                         jd.upper_inverse(jnp.asarray(U)), U)):
        assert rel_maxnorm(got.numpy(), np.asarray(ref)) < 1e-12
        assert np.allclose(got.numpy() @ M, np.eye(k), atol=1e-12)
