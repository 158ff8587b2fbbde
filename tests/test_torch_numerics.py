"""The numerical-trust layer's parts in both packages: the Hager-Higham
estimator (`inv_norm_est`, `estimate_rcond`, `ensure_rcond`),
`ConditionPolicy` in its three modes, the perturbation ledger, the
escalation-trigger labels and the pivot-growth probe.

Both packages see the same seeded numpy inputs.  The reference's
handles come from its host backend (its numpy factorization, no
compilation); the port's run the plain PyTorch versions on the CPU.
Tolerances: rcond to 1e-8 relative with float64 factors and 1e-4 with
float32 factors (the estimator's solves run without refinement, so
they carry the factor dtype's rounding); pure-numpy parts bit for bit.
Flags are set only through monkeypatch.setenv.
"""

import dataclasses

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (two torch threads per worker)
import scipy.sparse as sp

EPS = float(np.finfo(np.float64).eps)


def _dup_rows(pkg):
    """laplacian_2d(6) with row 5 := row 4: GESP replaces tiny pivots
    (the reference's own ledger input)."""
    dense = np.asarray(pkg.utils.testmat.laplacian_2d(6).to_scipy()
                       .todense())
    dense[5, :] = dense[4, :]
    return pkg.csr_from_scipy(sp.csr_matrix(dense))


def _tiny_diag(pkg):
    """A 64×64 tridiagonal matrix whose first 40 diagonal entries are
    1e-30, without equilibration: 40 replaced pivots, more than the
    ledger's 32 locations."""
    n = 64
    d = np.ones(n)
    d[:40] = 1e-30
    m = sp.diags([0.25 * np.ones(n - 1), d, 0.25 * np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    # keep the coupling out of the tiny block's pivots
    m = sp.csr_matrix(np.triu(m.toarray()))
    return pkg.csr_from_scipy(m)


def _pkgs():
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu.utils.testmat  # noqa: F401
    import superlu_dist_tpu_torch as st
    import superlu_dist_tpu_torch.utils.testmat  # noqa: F401
    return jslu, st


def _handles(make, factor_dtype="float64", **kw):
    """The same matrix factorized by the reference's host backend and
    by the port on the CPU."""
    jslu, st = _pkgs()
    aj, at = make(jslu), make(st)
    luj = jslu.factorize(aj, jslu.Options(factor_dtype=factor_dtype,
                                          **kw), backend="host")
    lut = st.factorize(at, st.Options(factor_dtype=factor_dtype, **kw),
                       device="cpu")
    return luj, lut


def test_one_norm_and_sign_match_reference():
    from superlu_dist_tpu.numerics import gscon as jg
    from superlu_dist_tpu_torch.numerics import gscon as tg
    jslu, st = _pkgs()
    for name, args in (("laplacian_2d", (7,)),
                       ("random_unsymmetric", (90,))):
        aj = getattr(jslu.utils.testmat, name)(*args)
        at = getattr(st.utils.testmat, name)(*args)
        assert tg.one_norm(at) == jg.one_norm(aj)
    y = np.random.default_rng(3).standard_normal(50)
    y[[4, 9]] = 0.0
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(tg._sign(y.astype(dt)),
                                      jg._sign(y.astype(dt)))


@pytest.mark.parametrize("case", ["dense", "nonfinite", "empty"])
def test_inv_norm_est_matches_reference(case):
    """The same solve callback in both packages gives the same estimate
    bit for bit, at several iteration caps; a non-finite solve gives
    inf, an empty system 0."""
    from superlu_dist_tpu.numerics import gscon as jg
    from superlu_dist_tpu_torch.numerics import gscon as tg
    rng = np.random.default_rng(11)
    n = 0 if case == "empty" else 40
    A = rng.standard_normal((n, n)) + np.diag(np.logspace(0, 6, n))
    inv = np.linalg.inv(A) if n else A
    calls = []

    def solve_fn(v, trans):
        calls.append(trans)
        y = (inv.T if trans else inv) @ v
        if case == "nonfinite" and len(calls) == 3:
            y[0] = np.nan
        return y

    for max_iter in (1, 2, 5):
        calls.clear()
        got = tg.inv_norm_est(solve_fn, n, np.float64, max_iter=max_iter)
        n_port = len(calls)
        calls.clear()
        want = jg.inv_norm_est(solve_fn, n, np.float64, max_iter=max_iter)
        assert got == want and n_port == len(calls)
        assert n_port <= 2 * max_iter + 2
        if case == "dense":
            assert want <= np.abs(inv).sum(axis=0).max() * (1 + 1e-12)
        elif case == "nonfinite":
            assert got == float("inf")
        else:
            assert got == 0.0


@pytest.mark.parametrize("make,factor_dtype,maxiter,tol", [
    ("laplacian_2d", "float64", None, 1e-8),
    ("convection_diffusion_2d", "float32", "2", 1e-4)])
def test_estimate_rcond_matches_reference(monkeypatch, make, factor_dtype,
                                          maxiter, tol):
    from superlu_dist_tpu.numerics import gscon as jg
    from superlu_dist_tpu_torch.numerics import gscon as tg
    if maxiter:
        monkeypatch.setenv("SLU_COND_MAXITER", maxiter)
    k = {"laplacian_2d": 10, "convection_diffusion_2d": 12}[make]
    luj, lut = _handles(lambda p: getattr(p.utils.testmat, make)(k),
                        factor_dtype)
    rj, rt = jg.estimate_rcond(luj), tg.estimate_rcond(lut)
    assert 0.0 < rj < 1.0
    assert abs(rt - rj) <= tol * rj
    assert lut.rcond is None            # estimate_rcond does not cache


def test_ensure_rcond_caches_on_the_handle(monkeypatch):
    """The first call pays at most 2·SLU_COND_MAXITER + 2 refinement-free
    solves on the resident factors (no factorization); later calls and
    replace copies read the cached value; the value is the reference's."""
    from superlu_dist_tpu.numerics import gscon as jg
    from superlu_dist_tpu_torch.models import gssvx as gm
    from superlu_dist_tpu_torch.numerics import gscon as tg
    from superlu_dist_tpu_torch.options import IterRefine
    luj, lut = _handles(lambda p: p.utils.testmat.random_unsymmetric(120))
    solves, orig = [], gm.solve

    def counted(lu, b, stats=None):
        solves.append((lu.effective_options.trans.name,
                       lu.effective_options.iter_refine))
        assert lu.device_lu is lut.device_lu
        return orig(lu, b, stats=stats)

    def no_factorize(*a, **k):
        raise AssertionError("the estimator factorized")

    monkeypatch.setattr(gm, "solve", counted)
    monkeypatch.setattr(gm, "factorize", no_factorize)
    r = tg.ensure_rcond(lut)
    assert 3 <= len(solves) <= 2 * 5 + 2
    assert {t for t, _ in solves} == {"NOTRANS", "TRANS"}
    assert {i for _, i in solves} == {IterRefine.NOREFINE}
    assert lut.rcond == r
    assert tg.ensure_rcond(lut) == r and len(solves) <= 12
    n = len(solves)
    copy = dataclasses.replace(lut)
    assert tg.ensure_rcond(copy) == r and len(solves) == n
    rj = jg.ensure_rcond(luj)
    assert abs(r - rj) <= 1e-8 * rj


def test_nonfinite_factors_give_rcond_zero_and_the_floor():
    """Poisoned factors: the estimate is 0.0 in both packages, and the
    policy refuses it at the floor instead of comparing a NaN."""
    import torch
    from superlu_dist_tpu.numerics import gscon as jg
    from superlu_dist_tpu_torch.numerics import gscon as tg
    from superlu_dist_tpu_torch.numerics.errors import SingularMatrixError
    from superlu_dist_tpu_torch.numerics.policy import ConditionPolicy
    luj, lut = _handles(lambda p: p.utils.testmat.laplacian_2d(6))
    for U in luj.host_lu.U:
        U[...] = np.nan
    for _, U, _, _ in lut.device_lu.panels:
        U.fill_(float("nan"))
    assert not bool(torch.isfinite(lut.device_lu.panels[0][1]).all())
    assert jg.estimate_rcond(luj) == tg.estimate_rcond(lut) == 0.0
    with pytest.raises(SingularMatrixError) as e:
        ConditionPolicy().enforce(tg.estimate_rcond(lut), "float64")
    assert e.value.rcond == 0.0


_RCONDS = [None, 0.0, 1e-300, EPS / 2, EPS, 1e-12, 1e-9, 1e-8,
           float(np.sqrt(np.finfo(np.float32).eps)), 1e-3, 0.5, 1.0]


@pytest.mark.parametrize("mode", ["serve", "stamp", "refuse"])
def test_condition_policy_matches_reference(monkeypatch, mode):
    """classify / enforce / thresholds over a grid of estimates and
    both refine dtypes, with automatic thresholds and with
    SLU_COND_FLOOR / _STAMP set."""
    from superlu_dist_tpu.numerics.errors import \
        SingularMatrixError as JSingular
    from superlu_dist_tpu.numerics.policy import ConditionPolicy as JP
    from superlu_dist_tpu_torch.numerics.errors import SingularMatrixError
    from superlu_dist_tpu_torch.numerics.policy import ConditionPolicy as TP

    def outcome(p, r, dt, exc):
        try:
            return p.enforce(r, dt)
        except exc as e:
            return ("raised", e.rcond)

    monkeypatch.setenv("SLU_COND_POLICY", mode)
    for env in ({}, {"SLU_COND_FLOOR": "1e-10", "SLU_COND_STAMP": "1e-4"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jp, tp = JP.from_env(), TP.from_env()
        port = dataclasses.asdict(tp)
        assert port == {k: v for k, v in dataclasses.asdict(jp).items()
                        if k in port}
        for dt in ("float64", "float32"):
            assert tp.floor_for(dt) == jp.floor_for(dt)
            assert tp.stamp_for(dt) == jp.stamp_for(dt)
            for r in _RCONDS:
                assert tp.classify(r, dt) == jp.classify(r, dt)
                assert outcome(tp, r, dt, SingularMatrixError) == \
                    outcome(jp, r, dt, JSingular)
    # the port's one deliberate difference: a NaN estimate is refused
    # at the floor, never classified 'ok'
    assert tp.classify(float("nan"), "float64") == "singular"
    with pytest.raises(ValueError):
        TP(mode="sometimes")


@pytest.mark.parametrize("case", ["dup_rows_f64", "dup_rows_f32", "clean",
                                  "truncated"])
def test_build_ledger_matches_reference(case):
    """Count, threshold, original-column locations, truncation and
    injected magnitude equal the reference's."""
    make = {"dup_rows_f64": _dup_rows, "dup_rows_f32": _dup_rows,
            "clean": lambda p: p.utils.testmat.laplacian_2d(6),
            "truncated": _tiny_diag}[case]
    fdt = "float32" if case == "dup_rows_f32" else "float64"
    kw = {"equil": False} if case == "truncated" else {}
    luj, lut = _handles(make, fdt, **kw)
    from superlu_dist_tpu_torch.numerics.ledger import build_ledger
    lj, lt = luj.ledger, lut.ledger
    assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
    assert build_ledger(lut) == lt
    assert lt.perturbed == (case != "clean")
    if case == "truncated":
        assert lt.count == 40 and lt.truncated
        assert lt.locations == tuple(range(32))


def test_classify_trigger_matches_reference():
    from superlu_dist_tpu.precision.policy import \
        classify_trigger as jct
    from superlu_dist_tpu_torch.precision.policy import \
        classify_trigger as tct
    f32 = float(np.finfo(np.float32).eps)
    seen = set()
    for berr in (1e-3, float("nan"), float("inf"), 1e-17):
        for stalled in (False, True):
            for growth in (None, 1.0, 1e5, 1e7, 1e9):
                for feps in (None, f32, EPS):
                    kw = dict(stalled=stalled, pivot_growth=growth,
                              factor_eps=feps)
                    got = tct(berr, **kw)
                    assert got == jct(berr, **kw)
                    seen.add(got)
    assert seen == {"nonfinite", "pivot_growth", "refine_stalled",
                    "berr_plateau"}


@pytest.mark.parametrize("case", ["dup_rows_f64", "clean_f32", "unprobeable"])
def test_pivot_growth_matches_reference(monkeypatch, case):
    from superlu_dist_tpu.obs.health import pivot_growth as jpg
    from superlu_dist_tpu_torch.numerics import health
    if case == "unprobeable":
        events = []
        monkeypatch.setattr(health, "record",
                            lambda ev, **kw: events.append((ev, kw)))
        assert health.pivot_growth(object()) is None
        assert events == [("pivot_growth_unavailable", {"dtype": ""})]
        return
    if case == "dup_rows_f64":
        luj, lut = _handles(_dup_rows)
        tol = 1e-10
    else:
        luj, lut = _handles(lambda p: p.utils.testmat.laplacian_2d(8),
                            "float32")
        tol = 1e-5
    gj, gt = jpg(luj), health.pivot_growth(lut)
    assert gj > 0 and abs(gt - gj) <= tol * gj


def test_stamp_and_strip_match_reference():
    from superlu_dist_tpu.numerics import ledger as jl
    from superlu_dist_tpu_torch.numerics import ledger as tl
    kw = dict(count=2, threshold=1e-8, locations=(1, 3),
              total_magnitude=2e-8)
    led = tl.PerturbationLedger(**kw)
    assert led.to_dict() == jl.PerturbationLedger(**kw).to_dict()
    x = tl.stamp_perturbed(np.ones((4, 2)), ledger=led, rcond=1e-9)
    col = x[:, 0]
    assert isinstance(col, tl.PerturbedResult)
    assert col.ledger is led and col.rcond == 1e-9
    for mod in (tl, jl):
        plain = mod.strip_result_markers(x)
        assert type(plain) is np.ndarray and np.shares_memory(plain, x)
        assert mod.strip_result_markers([1]) == [1]
    assert type(np.asarray(x)) is np.ndarray          # asarray strips it
