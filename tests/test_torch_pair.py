"""Pair storage of complex systems (SLU_COMPLEX_PAIR=1): the port's
ops/pair_lu.py against the reference's on the same seeded inputs, and
pair-stored factorizations against the port's native complex path and
the reference's host backend.

Tolerances: the pair kernels agree with the reference's to 1e-13
relative in max-norm, with equal tiny- and zero-pivot counts; pair-
stored solves agree with native complex storage and with the host
backend to 1e-10 relative (a complex64 factor with complex128
refinement too).  The reference's own pair sweeps are not an oracle on
this host (its legacy pair-plane sweep lands 0.0426 off), so no test
here reads them."""

import numpy as np
import pytest
import torch

from superlu_dist_tpu_torch.ops import pair_lu as tp


@pytest.fixture(scope="module")
def problem():
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    aj, at = jtm.helmholtz_2d(12), ttm.helmholtz_2d(12)
    rng = np.random.default_rng(11)
    xt = rng.standard_normal((at.n, 4)) + 1j * rng.standard_normal(
        (at.n, 4))
    return aj, at, xt


def _rel(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y)))
                 / np.max(np.abs(np.asarray(y))))


def _fronts(seed, N, mb):
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal((N, mb, mb))
         + 1j * rng.standard_normal((N, mb, mb)))
    return F + mb * np.eye(mb)


def _enc(x):
    return np.stack([np.real(x), np.imag(x)])


# --------------------------------------------------------------------
# ops/pair_lu.py against the reference's
# --------------------------------------------------------------------

@pytest.mark.parametrize("mb,wb", [(8, 8), (48, 32), (96, 64)])
def test_partial_lu_pair_matches_reference(mb, wb):
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import pair_lu as jp
    Fp = _enc(_fronts(mb, 3, mb))
    Fj, tj, zj = jp.partial_lu_pair_batch(jnp.asarray(Fp),
                                          jnp.asarray(0.0), wb=wb)
    Ft, tt_, zt = tp.partial_lu_pair_batch(torch.from_numpy(Fp.copy()),
                                           0.0, wb=wb)
    assert _rel(Ft.numpy(), np.asarray(Fj)) <= 1e-13
    assert (int(tt_), int(zt)) == (int(tj), int(zj))


def test_tiny_and_zero_pivot_counts_match_reference():
    """Fronts with an exactly zero leading pivot and a tiny one: with a
    threshold both are replaced (counted tiny), without one the zero
    counts as a zero pivot; counts and factors equal the reference's,
    and the single-front partial_lu_pair agrees with the batch."""
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import pair_lu as jp
    F = _fronts(2, 2, 16)
    F[0, 0, :] = 0.0
    F[1, 3, :] = 0.0
    F[1, :, 3] = 0.0
    F[1, 3, 3] = 1e-14
    Fp = _enc(F)
    for thresh in (1e-8, 0.0):
        Fj, tj, zj = jp.partial_lu_pair_batch(jnp.asarray(Fp),
                                              jnp.asarray(thresh), wb=8)
        Ft, tt_, zt = tp.partial_lu_pair_batch(
            torch.from_numpy(Fp.copy()), thresh, wb=8)
        assert (int(tt_), int(zt)) == (int(tj), int(zj))
        if thresh:
            assert (int(tt_), int(zt)) == (2, 0)
            assert _rel(Ft.numpy(), np.asarray(Fj)) <= 1e-13
        else:
            assert int(zt) >= 1
    one, t1, z1 = tp.partial_lu_pair(torch.from_numpy(Fp[:, 1].copy()),
                                     1e-8, wb=8)
    assert (int(t1), int(z1)) == (1, 0)


def test_tri_inverses_pair_match_reference():
    """The pair triangular inverses (Newton leaves and the blocked
    recursion above 64) against the reference's and against the
    complex inverse."""
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import pair_lu as jp
    rng = np.random.default_rng(3)
    for w in (48, 96):
        A = (rng.standard_normal((2, w, w))
             + 1j * rng.standard_normal((2, w, w)))
        L = np.tril(A, -1) / w + np.eye(w)
        U = np.triu(A) / w + 2 * np.eye(w)
        for ft, fj, T in ((tp.unit_lower_inverse_pair,
                           jp.unit_lower_inverse_pair, L),
                          (tp.upper_inverse_pair, jp.upper_inverse_pair,
                           U)):
            got = ft(torch.from_numpy(_enc(T)))
            assert _rel(got.numpy(), np.asarray(fj(jnp.asarray(
                _enc(T))))) <= 1e-13
            assert _rel(tp.decode(got).numpy(), np.linalg.inv(T)) <= 1e-12


def test_pair_algebra_matches_reference():
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import pair_lu as jp
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 5, 4))
    b = rng.standard_normal((2, 3, 4, 6))
    c = rng.standard_normal((2, 3, 5, 4)) + 0.5
    ta, tb_, tc = (torch.from_numpy(x) for x in (a, b, c))
    ja, jb_, jc = (jnp.asarray(x) for x in (a, b, c))
    pairs = [(tp.pmul(ta, tc), jp.pmul(ja, jc)),
             (tp.pdiv(ta, tc), jp.pdiv(ja, jc)),
             (tp.pabs(ta), jp.pabs(ja)),
             (tp.pmatmul(ta, tb_), jp.pmatmul(ja, jb_)),
             (tp.peinsum("nij,njk->nik", ta, tb_),
              jp.peinsum("nij,njk->nik", ja, jb_))]
    for got, want in pairs:
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-14
    z = a[0] + 1j * a[1]
    assert np.array_equal(tp.encode(torch.from_numpy(z)).numpy(), a)
    assert np.array_equal(tp.decode(ta).numpy(), z)


# --------------------------------------------------------------------
# pair-stored factorizations
# --------------------------------------------------------------------

@pytest.mark.parametrize("staged", ["1", "0"])
def test_gssvx_pair_matches_native_and_host(problem, staged,
                                            monkeypatch):
    """c128 gssvx on pair storage, staged and whole-phase arms: the
    handle holds (2, N) real planes whose decode equals the native
    factors, and x agrees with the native path and with the
    reference's host backend to 1e-10, equal tiny counts."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at, xt = problem
    b = at.to_scipy() @ xt[:, 0]
    monkeypatch.setenv("SLU_STAGED", staged)
    x0, lu0, s0 = st.gssvx(st.Options(), at, b, device="cpu")
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    x1, lu1, s1 = st.gssvx(st.Options(), at, b, device="cpu")
    xh, _, sh = jslu.gssvx(jslu.Options(), aj, b, backend="host")
    for p0, p1 in zip(lu0.device_lu.panels, lu1.device_lu.panels):
        for f0, f1 in zip(p0, p1):
            assert f1.dim() == 2 and f1.dtype == torch.float64
            assert _rel(torch.complex(f1[0], f1[1]).numpy(),
                        f0.numpy()) <= 1e-12
    assert _rel(x1, x0) <= 1e-10 and _rel(x1, xh) <= 1e-10
    assert s1.tiny_pivots == s0.tiny_pivots == sh.tiny_pivots
    np.testing.assert_allclose(st.get_diag_u(lu1), st.get_diag_u(lu0),
                               rtol=1e-12)


def test_gssvx_pair_c64_factor_c128_refine(problem, monkeypatch):
    """A complex64 factor on float32 planes with complex128 refinement
    reaches the native complex64 path's x to 1e-10."""
    import superlu_dist_tpu_torch as st
    _, at, xt = problem
    b = at.to_scipy() @ xt[:, 1]
    opts = st.Options(factor_dtype="float32")
    x0, _, s0 = st.gssvx(opts, at, b, device="cpu")
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    x1, lu1, s1 = st.gssvx(opts, at, b, device="cpu")
    assert lu1.device_lu.panels[0][0].dtype == torch.float32
    assert lu1.effective_options.factor_dtype == "complex64"
    assert _rel(x1, x0) <= 1e-10 and _rel(x1, xt[:, 1]) <= 1e-10
    assert s1.escalations == s0.escalations == 0


@pytest.mark.parametrize("trans", ["TRANS", "CONJ"])
def test_gssvx_pair_trans_conj_nrhs4(problem, trans, monkeypatch):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at, xt = problem
    asp = at.to_scipy()
    b = (asp.T if trans == "TRANS" else asp.conj().T) @ xt
    opts = st.Options(trans=st.Trans[trans])
    x0, _, _ = st.gssvx(opts, at, b, device="cpu")
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    x1, _, _ = st.gssvx(opts, at, b, device="cpu")
    xh, _, _ = jslu.gssvx(jslu.Options(trans=jslu.Trans[trans]), aj, b,
                          backend="host")
    assert x1.shape == (at.n, 4)
    assert _rel(x1, x0) <= 1e-10 and _rel(x1, xh) <= 1e-10


def test_pair_singular_raises(monkeypatch):
    """An exactly zero pivot, stored explicitly, with tiny-pivot
    replacement off raises on pair storage as on native storage."""
    import scipy.sparse as sp
    import superlu_dist_tpu_torch as st
    n = 12
    d = np.ones(n, np.complex128)
    d[7] = 0.0
    idx = np.arange(n)
    a = st.csr_from_scipy(sp.csr_matrix((d, (idx, idx)), shape=(n, n)))
    opts = st.Options(replace_tiny_pivot=False, equil=False,
                      row_perm=st.RowPerm.NOROWPERM)
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    with pytest.raises(ZeroDivisionError):
        st.gssvx(opts, a, np.ones(n, complex), device="cpu")


@pytest.mark.parametrize("staged", [True, False])
def test_fused_solver_pair(problem, staged, monkeypatch):
    """make_fused_solver in complex128 on pair storage, twice on one
    context (the second factorization decodes into the same solve
    flats), against the native step: x to 1e-10, equal counts."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops.batched import make_fused_solver
    _, at, xt = problem
    plan = st.plan_factorization(at, device="cpu")
    b = at.to_scipy() @ xt
    x0, _, _, t0, _ = make_fused_solver(plan, np.complex128,
                                        staged=staged)(at.data, b)
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    step = make_fused_solver(plan, np.complex128, staged=staged)
    assert step.context.pair and step.context.staged == staged
    step(at.data * 2, b)
    x1, berr, _, t1, z1 = step(at.data, b)
    assert _rel(x1.numpy(), x0.numpy()) <= 1e-10
    assert (int(t1), int(z1)) == (int(t0), 0)
    assert float(berr) <= 64 * np.finfo(np.float64).eps


def test_pair_handle_survives_env_change(problem, monkeypatch):
    """The handle's storage decides how it is solved: a pair handle
    solved after SLU_COMPLEX_PAIR is unset (FACTORED) still solves
    through its complex decode, and its planes handed to the native
    pack raise."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import trisolve
    _, at, xt = problem
    b = at.to_scipy() @ xt[:, 2]
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    _, lu, _ = st.gssvx(st.Options(), at, b, device="cpu")
    monkeypatch.delenv("SLU_COMPLEX_PAIR")
    x, lu2, _ = st.gssvx(st.Options(fact=st.Fact.FACTORED), at, b,
                         lu=lu, device="cpu")
    assert lu2.device_lu.panels[0][0].dim() == 2
    assert _rel(x, xt[:, 2]) <= 1e-10
    ts = trisolve.get_trisolve(lu.device_lu.schedule)
    with pytest.raises(TypeError, match="pair-stored"):
        trisolve.pack_panels_staged(ts, lu.device_lu.panels)


def test_pair_condition_estimate(problem, monkeypatch):
    """With SLU_COND_ESTIMATE=1 the gate's rcond on a pair handle
    equals the native handle's to 1e-8."""
    import superlu_dist_tpu_torch as st
    _, at, xt = problem
    b = at.to_scipy() @ xt[:, 3]
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    _, _, s0 = st.gssvx(st.Options(), at, b, device="cpu")
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    _, _, s1 = st.gssvx(st.Options(), at, b, device="cpu")
    assert s0.rcond > 0
    assert abs(s1.rcond - s0.rcond) <= 1e-8 * s0.rcond
