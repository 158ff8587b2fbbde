"""The host backend (ops/ref_multifrontal.py, `backend="host"`) against
the JAX package's host backend on the same inputs: laplacian_2d(10),
convection_diffusion_2d(12) and random_unsymmetric(150) (under
RowPerm.NOROWPERM it replaces pivots, at density 0.01 in float64 and
at 0.03 in float32, where the 0.01 one overflows), plus a Laplacian shifted next to
an eigenvalue (κ ≈ 1e9), whose float32 factor fails its refinement
contract and escalates.  Both packages run the same numpy code on the
same plan, so the panels agree to rounding; solutions agree to κ·eps.
"""

import numpy as np
import pytest

from torch_port_util import flatten, rel_maxnorm

EPS = np.finfo(np.float64).eps
BERR_MAX = 64 * EPS
PANEL_TOL = {"float64": 1e-13, "float32": 1e-5}


def _shifted_lap(tm):
    """laplacian_2d(10) − (λ_min − 1e-9)·I: symmetric, κ ≈ 1e9."""
    import scipy.sparse as sp
    lap = tm.laplacian_2d(10).to_scipy()
    lam = 4.0 - 4.0 * np.cos(np.pi / 11.0)
    return tm.csr_from_scipy((lap - (lam - 1e-9)
                              * sp.identity(lap.shape[0])).tocsr())


CASES = {
    "lap10": lambda tm: tm.laplacian_2d(10),
    "convdiff12": lambda tm: tm.convection_diffusion_2d(12),
    "randunsym150": lambda tm: tm.random_unsymmetric(150),
    "randunsym150d03": lambda tm: tm.random_unsymmetric(150, density=0.03),
    "shifted": _shifted_lap,
}


def _pair(name):
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    aj, at = CASES[name](jtm), CASES[name](ttm)
    assert np.array_equal(aj.data, at.data)
    return aj, at


def _rhs(a, seed=0, trans=False):
    xt = np.random.default_rng(seed).standard_normal(a.n)
    asp = a.to_scipy()
    return xt, (asp.T if trans else asp) @ xt


def _relerr(x, xt):
    return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))


def _plans(name, row_perm="LARGE_DIAG_MC64"):
    """The reference's plan and the same plan carried into the port."""
    import superlu_dist_tpu as jslu
    from superlu_dist_tpu.plan.plan import plan_factorization
    from superlu_dist_tpu_torch import interop
    aj, _ = _pair(name)
    pj = plan_factorization(aj, jslu.Options(
        row_perm=jslu.RowPerm[row_perm]))
    return aj, pj, interop.plan_from_arrays(flatten(pj), device="cpu")


@pytest.mark.parametrize("name,row_perm,dtype", [
    ("lap10", "LARGE_DIAG_MC64", "float64"),
    ("convdiff12", "LARGE_DIAG_MC64", "float64"),
    ("convdiff12", "LARGE_DIAG_MC64", "float32"),
    ("randunsym150", "LARGE_DIAG_MC64", "float64"),
    ("randunsym150", "NOROWPERM", "float64"),
    ("randunsym150d03", "NOROWPERM", "float32"),
])
def test_factorize_host_panels_match_reference(name, row_perm, dtype):
    from superlu_dist_tpu.ops import ref_multifrontal as jref
    from superlu_dist_tpu_torch.ops import ref_multifrontal as tref
    aj, pj, pt = _plans(name, row_perm)
    scaled = pj.scaled_values(aj)
    assert np.array_equal(scaled, pt.scaled_values(aj))
    with np.errstate(all="ignore"):     # NOROWPERM float32 overflows
        hj = jref.factorize_host(pj, scaled, dtype=np.dtype(dtype))
        ht = tref.factorize_host(pt, scaled, dtype=np.dtype(dtype))
    assert ht.tiny_pivots == hj.tiny_pivots
    if row_perm == "NOROWPERM":
        assert ht.tiny_pivots > 0
    for side in ("L", "U", "Linv", "Uinv"):
        for pa, pb in zip(getattr(ht, side), getattr(hj, side)):
            assert pa.dtype == pb.dtype == np.dtype(dtype)
            fin = np.isfinite(pb)
            assert np.array_equal(fin, np.isfinite(pa))
            assert rel_maxnorm(pa[fin], pb[fin]) <= PANEL_TOL[dtype]


@pytest.mark.parametrize("name", ["lap10", "convdiff12", "randunsym150"])
def test_solve_host_and_trans_match_reference(name):
    from superlu_dist_tpu.ops import ref_multifrontal as jref
    from superlu_dist_tpu_torch.ops import ref_multifrontal as tref
    aj, pj, pt = _plans(name)
    scaled = pj.scaled_values(aj)
    hj = jref.factorize_host(pj, scaled)
    ht = tref.factorize_host(pt, scaled)
    b = np.random.default_rng(3).standard_normal((aj.n, 2))
    for fj, ft in ((jref.solve_host, tref.solve_host),
                   (jref.solve_host_trans, tref.solve_host_trans)):
        assert rel_maxnorm(ft(ht, b), fj(hj, b)) <= 1e-13
        assert ft(ht, b[:, 0]).shape == (aj.n,)


@pytest.mark.parametrize("name,dtype,trans", [
    ("convdiff12", "float64", False), ("convdiff12", "float64", True),
    ("convdiff12", "float32", False), ("convdiff12", "float32", True),
    ("shifted", "float32", False),
])
def test_gssvx_host_matches_reference(name, dtype, trans):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = _pair(name)
    xt, b = _rhs(at, trans=trans)
    kw = dict(factor_dtype=dtype)
    tr = "TRANS" if trans else "NOTRANS"
    xj, _, sj = jslu.gssvx(jslu.Options(trans=jslu.Trans[tr], **kw), aj,
                           b, backend="host")
    x, lu, s = st.gssvx(st.Options(trans=st.Trans[tr], **kw), at, b,
                        backend="host")
    assert lu.backend == "host" and lu.device_lu is None
    assert s.berr <= BERR_MAX and sj.berr <= BERR_MAX
    assert s.escalations == sj.escalations
    assert s.tiny_pivots == sj.tiny_pivots
    assert _relerr(x, xt) <= 10 * max(_relerr(xj, xt), EPS)
    if name == "shifted":
        assert s.escalations == 1 and s.utime["FACT_ESC"] > 0
        assert lu.effective_options.factor_dtype == "float64"


def test_fact_ladder_host_matches_reference():
    """DOFACT, then SAME_PATTERN and SAME_PATTERN_SAME_ROWPERM on new
    values and FACTORED with a new right-hand side, each on the host
    handle of the rung before, in both packages."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = _pair("convdiff12")
    _, b = _rhs(at)
    _, luj, _ = jslu.gssvx(jslu.Options(), aj, b, backend="host")
    _, lut, _ = st.gssvx(st.Options(), at, b, backend="host")
    scale = 1.0 + 0.1 * np.random.default_rng(1).random(at.nnz)
    a2j = jslu.CSRMatrix(aj.m, aj.n, aj.indptr, aj.indices,
                         aj.data * scale)
    a2t = st.CSRMatrix(at.m, at.n, at.indptr, at.indices,
                       at.data * scale)
    for fact, seed in (("SAME_PATTERN", 4), ("SAME_PATTERN_SAME_ROWPERM",
                                             5), ("FACTORED", 6)):
        xt, b2 = _rhs(a2t, seed=seed)
        xj, luj, sj = jslu.gssvx(jslu.Options(fact=jslu.Fact[fact]), a2j,
                                 b2, lu=luj, backend="host")
        x, lu2, s = st.gssvx(st.Options(fact=st.Fact[fact]), a2t, b2,
                             lu=lut, backend="host")
        assert lu2.backend == "host" and s.berr <= BERR_MAX
        assert _relerr(x, xt) <= 10 * max(_relerr(xj, xt), EPS)
        if fact == "FACTORED":
            assert lu2.host_lu is lut.host_lu
        lut = lu2


def test_handle_surface_host_matches_reference():
    """get_diag_u, query_space, factor_arrays and factors_finite of a
    host handle, and its device."""
    import importlib
    import torch
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    jg = importlib.import_module("superlu_dist_tpu.models.gssvx")
    tg = importlib.import_module("superlu_dist_tpu_torch.models.gssvx")
    aj, at = _pair("randunsym150")
    luj = jslu.factorize(aj, jslu.Options(), backend="host")
    lut = st.factorize(at, st.Options(), backend="host")
    assert lut.device == torch.device("cpu")
    assert rel_maxnorm(tg.get_diag_u(lut), jg.get_diag_u(luj)) <= 1e-13
    assert tg.query_space(lut) == jg.query_space(luj)
    fa_t, fa_j = tg.factor_arrays(lut), jg.factor_arrays(luj)
    assert len(fa_t) == len(fa_j)
    assert all(rel_maxnorm(p, q) <= 1e-13 for p, q in zip(fa_t, fa_j))
    assert tg.factors_finite(lut) and jg.factors_finite(luj)
    lut.host_lu.U[0][0, 0] = np.nan
    assert not tg.factors_finite(lut)


def test_ledger_host_matches_reference():
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = _pair("randunsym150")
    luj = jslu.factorize(aj, jslu.Options(row_perm=jslu.RowPerm.NOROWPERM),
                         backend="host")
    lut = st.factorize(at, st.Options(row_perm=st.RowPerm.NOROWPERM),
                       backend="host")
    assert lut.ledger.perturbed
    assert lut.ledger.to_dict() == luj.ledger.to_dict()


@pytest.mark.parametrize("name", ["lap10", "convdiff12", "randunsym150"])
def test_gate_host_rcond_matches_reference(name, monkeypatch):
    """SLU_COND_ESTIMATE=1: the estimator's solves go through
    solve_host/solve_host_trans on dataclasses.replace copies of the
    host handle; rcond within 1e-8 of the reference's host backend."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    aj, at = _pair(name)
    _, b = _rhs(at)
    _, luj, sj = jslu.gssvx(jslu.Options(), aj, b, backend="host")
    _, lut, s = st.gssvx(st.Options(), at, b, backend="host")
    assert lut.rcond is not None and s.rcond == lut.rcond
    assert abs(lut.rcond - luj.rcond) <= 1e-8 * luj.rcond


def test_host_backend_needs_no_card(monkeypatch):
    """backend="host" runs with no card and without device=, and never
    resolves a device."""
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.models import gssvx as tg
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d

    def no_resolve(*a, **k):
        raise AssertionError("the host backend resolved a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tg, "resolve_device", no_resolve)
    a = laplacian_2d(6)
    xt, b = _rhs(a)
    x, lu, s = st.gssvx(st.Options(), a, b, backend="host")
    assert _relerr(x, xt) <= 1e-13 and lu.plan.device is None
    lu2 = st.factorize(a, st.Options(), backend="host")
    assert lu2.backend == "host"


def test_backend_choices(monkeypatch):
    """"auto" is "torch" (never "host"): with no card and no device it
    refuses; "dist" and grid= name the multi-GPU item; an unknown
    backend is refused."""
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.device import NoCudaDeviceError
    from superlu_dist_tpu_torch.models.gssvx import resolve_backend
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    assert resolve_backend("auto") == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = laplacian_2d(4)
    b = np.ones(a.n)
    for be in ("auto", "torch"):
        with pytest.raises(NoCudaDeviceError):
            st.gssvx(st.Options(), a, b, backend=be)
        with pytest.raises(NoCudaDeviceError):
            st.factorize(a, backend=be)
    _, lu, _ = st.gssvx(st.Options(), a, b, backend="auto", device="cpu")
    assert lu.backend == "torch"
    for kw in ({"backend": "dist"}, {"grid": object()}):
        with pytest.raises(ValueError, match="item 15"):
            st.gssvx(st.Options(), a, b, device="cpu", **kw)
        with pytest.raises(ValueError, match="item 15"):
            st.factorize(a, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        st.gssvx(st.Options(), a, b, backend="jax", device="cpu")
