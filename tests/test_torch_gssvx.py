"""gssvx end to end in both packages: float64, and the float32-factor
mode (factor_dtype=solve_dtype=float32, float64 refinement).  Both
reach berr ≤ 64·eps(float64); the port's error against the true
solution stays within 10× of the JAX package's (floored at
eps(float64), where both sit at rounding level).  The Fact ladder —
FACTORED, SAME_PATTERN_SAME_ROWPERM, SAME_PATTERN — agrees too."""

import numpy as np
import pytest

from torch_port_util import MATRICES, matrix_pair

EPS = np.finfo(np.float64).eps
BERR_MAX = 64 * EPS


def _rhs(a, seed=0):
    xtrue = np.random.default_rng(seed).standard_normal(a.n)
    return xtrue, a.to_scipy() @ xtrue


def _relerr(x, xt):
    return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))


def _both(name, jopts, topts, trans=False):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = matrix_pair(name)
    xtrue, b = _rhs(at)
    if trans:
        b = at.to_scipy().T @ xtrue
    xj, _, sj = jslu.gssvx(jopts, aj, b)
    xt, lut, stt = st.gssvx(topts, at, b, device="cpu")
    return xtrue, (xj, sj), (xt, stt, lut)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gssvx_f64_matches_reference(name):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    xtrue, (xj, sj), (xt, stt, _) = _both(name, jslu.Options(),
                                          st.Options())
    assert sj.berr <= BERR_MAX and stt.berr <= BERR_MAX
    assert _relerr(xt, xtrue) <= 10 * max(_relerr(xj, xtrue), EPS)
    assert stt.tiny_pivots == sj.tiny_pivots


@pytest.mark.parametrize("name", ["lap3d6", "convdiff12"])
def test_gssvx_f32_factor_f64_refine(name):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    kw = dict(factor_dtype="float32", solve_dtype="float32")
    xtrue, (xj, sj), (xt, stt, lu) = _both(name, jslu.Options(**kw),
                                           st.Options(**kw))
    assert sj.berr <= BERR_MAX and stt.berr <= BERR_MAX
    assert stt.escalations == sj.escalations == 0
    assert lu.device_lu.dtype == np.float32
    assert _relerr(xt, xtrue) <= 10 * max(_relerr(xj, xtrue), EPS)


def test_gssvx_trans_matches_reference():
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    xtrue, (xj, sj), (xt, stt, _) = _both(
        "convdiff12", jslu.Options(trans=jslu.Trans.TRANS),
        st.Options(trans=st.Trans.TRANS), trans=True)
    assert sj.berr <= BERR_MAX and stt.berr <= BERR_MAX
    assert _relerr(xt, xtrue) <= 10 * max(_relerr(xj, xtrue), EPS)


def test_fact_ladder_matches_reference():
    """DOFACT, then FACTORED (a new right-hand side), then
    SAME_PATTERN_SAME_ROWPERM and SAME_PATTERN (new values on the same
    pattern): each rung solves in both packages."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = matrix_pair("convdiff12")
    _, b = _rhs(at)
    _, luj, _ = jslu.gssvx(jslu.Options(), aj, b)
    _, lut, _ = st.gssvx(st.Options(), at, b, device="cpu")
    # FACTORED: solve only, with a new right-hand side
    xtrue2, b2 = _rhs(at, seed=3)
    xj, _, sj = jslu.gssvx(jslu.Options(fact=jslu.Fact.FACTORED), aj, b2,
                           lu=luj)
    xt, lu2, stt = st.gssvx(st.Options(fact=st.Fact.FACTORED), at, b2,
                            lu=lut)
    assert lu2.device_lu is lut.device_lu          # no refactorization
    assert stt.berr <= BERR_MAX and sj.berr <= BERR_MAX
    assert _relerr(xt, xtrue2) <= 10 * max(_relerr(xj, xtrue2), EPS)
    # new values, same pattern
    scale = 1.0 + 0.1 * np.random.default_rng(4).random(at.nnz)
    for rung_j, rung_t in (
            (jslu.Fact.SAME_PATTERN_SAME_ROWPERM,
             st.Fact.SAME_PATTERN_SAME_ROWPERM),
            (jslu.Fact.SAME_PATTERN, st.Fact.SAME_PATTERN)):
        aj2 = jslu.CSRMatrix(aj.m, aj.n, aj.indptr, aj.indices,
                             aj.data * scale)
        at2 = st.CSRMatrix(at.m, at.n, at.indptr, at.indices,
                           at.data * scale)
        xtrue3, b3 = _rhs(at2, seed=5)
        xj, luj3, sj = jslu.gssvx(jslu.Options(fact=rung_j), aj2, b3,
                                  lu=luj)
        xt, lut3, stt = st.gssvx(st.Options(fact=rung_t), at2, b3,
                                 lu=lut, device="cpu")
        if rung_t == st.Fact.SAME_PATTERN_SAME_ROWPERM:
            assert lut3.plan is lut.plan                # plan reused
        else:
            np.testing.assert_array_equal(lut3.plan.perm_c,
                                          lut.plan.perm_c)
            np.testing.assert_array_equal(lut3.plan.perm_r,
                                          luj3.plan.perm_r)
        assert stt.berr <= BERR_MAX and sj.berr <= BERR_MAX
        assert _relerr(xt, xtrue3) <= 10 * max(_relerr(xj, xtrue3), EPS)


def test_gssvx_validates_like_reference():
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.numerics.errors import InvalidInputError
    _, at = matrix_pair("lap3d6")
    with pytest.raises(InvalidInputError):
        st.gssvx(st.Options(), at, np.ones(at.n + 1), device="cpu")
    b = np.ones(at.n)
    b[3] = np.nan
    with pytest.raises(InvalidInputError):
        st.gssvx(st.Options(), at, b, device="cpu")
    with pytest.raises(ValueError, match="requires an existing lu"):
        st.gssvx(st.Options(fact=st.Fact.FACTORED), at, np.ones(at.n),
                 device="cpu")


def test_escalation_climbs_one_rung():
    """A float32 factor whose refinement contract fails (no
    refinement steps allowed) is refactored in float64, once."""
    import superlu_dist_tpu_torch as st
    _, at = matrix_pair("convdiff12")
    xtrue, b = _rhs(at)
    opts = st.Options(factor_dtype="float32", max_refine_steps=0)
    x, lu, stats = st.gssvx(opts, at, b, device="cpu")
    assert stats.escalations == 1
    assert lu.device_lu.dtype == np.float64
    assert _relerr(x, xtrue) < 1e-12
