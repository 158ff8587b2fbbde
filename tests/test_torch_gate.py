"""gssvx with the condition gate on (SLU_COND_ESTIMATE=1), port against
the JAX package on the CPU, with the same seeded inputs and flags:

  * the three parity matrices through the reference's device path:
    rcond to 1e-8 relative (float64), the same class, stamp decision,
    escalations and ledger;
  * option sets that make the gate act (a float32 factor whose
    refinement is cut, an ill-conditioned class that pre-climbs the
    ladder, the refuse mode, a raised floor) against the reference's
    host backend: the same refusals, stamps, escalation count and each
    escalation's trigger label;
  * the hard-matrix gauntlet case by case (the same outcome as the
    reference's host backend, never silent_wrong or untyped);
  * the NOROWPERM case ROADMAP queue 3 recorded: a typed refusal or a
    stamp, never a plain result.

Flags are set only through monkeypatch.setenv.  The reference's
escalation labels are read from its health monitor's ring (read only);
the port's from its health seam, captured with monkeypatch.
"""

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (two torch threads per worker)

EPS = float(np.finfo(np.float64).eps)
BERR_MAX = 64 * EPS

_MATS = {"lap2d10": ("laplacian_2d", (10,), {}),
         "convdiff12": ("convection_diffusion_2d", (12,), {}),
         "randunsym150": ("random_unsymmetric", (150,), {})}


def _pair(name):
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    fn, args, kw = _MATS[name]
    return getattr(jtm, fn)(*args, **kw), getattr(ttm, fn)(*args, **kw)


def _rhs(n, nrhs=None, seed=0):
    shape = (n,) if nrhs is None else (n, nrhs)
    return np.random.default_rng(seed).standard_normal(shape)


def _port_events(monkeypatch):
    from superlu_dist_tpu_torch.numerics import health
    events = []
    monkeypatch.setattr(health, "record",
                        lambda ev, **kw: events.append((ev, kw)))
    return events


def _run_both(monkeypatch, aj, at, b, jopts, topts, backend):
    """(outcome, detail) per package: ('refused', (type, rcond)) or
    ('ok', (x, lu, stats, escalation triggers))."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu import obs
    from superlu_dist_tpu.numerics.errors import NumericalError as JNE
    from superlu_dist_tpu_torch.numerics.errors import NumericalError
    events = _port_events(monkeypatch)
    out = {}
    before = obs.HEALTH.snapshot()["escalations"]
    try:
        x, lu, s = jslu.gssvx(jopts, aj, b, backend=backend)
        k = obs.HEALTH.snapshot()["escalations"] - before
        trig = [e["trigger"] for e in
                obs.HEALTH.snapshot()["escalation_events"][-k:]] if k else []
        out["ref"] = ("ok", (x, lu, s, trig))
    except JNE as e:
        out["ref"] = ("refused", (type(e).__name__, e.rcond))
    try:
        x, lu, s = st.gssvx(topts, at, b, device="cpu")
        trig = [kw["trigger"] for ev, kw in events if ev == "escalation"]
        out["port"] = ("ok", (x, lu, s, trig))
    except NumericalError as e:
        out["port"] = ("refused", (type(e).__name__, e.rcond))
    return out["ref"], out["port"]


def _assert_same(ref, port, rtol=1e-8):
    from superlu_dist_tpu.numerics.ledger import PerturbedResult as JPR
    from superlu_dist_tpu_torch.numerics.ledger import PerturbedResult
    assert ref[0] == port[0], (ref, port)
    if ref[0] == "refused":
        assert ref[1][0] == port[1][0]
        rj, rt = ref[1][1], port[1][1]
        assert (rj is None) == (rt is None)
        if rj:
            assert abs(rt - rj) <= rtol * rj
        return
    xj, luj, sj, tj = ref[1]
    xt, lut, stt, tt = port[1]
    assert isinstance(xj, JPR) == isinstance(xt, PerturbedResult)
    assert sj.escalations == stt.escalations and tj == tt
    assert (sj.rcond is None) == (stt.rcond is None)
    if sj.rcond is not None:
        assert abs(stt.rcond - sj.rcond) <= rtol * sj.rcond
        assert lut.rcond == stt.rcond
    assert lut.ledger.to_dict() == luj.ledger.to_dict()
    assert lut.effective_options.factor_dtype == \
        luj.effective_options.factor_dtype
    assert stt.berr <= BERR_MAX and sj.berr <= BERR_MAX
    np.testing.assert_allclose(np.asarray(xt), np.asarray(xj),
                               rtol=1e-9, atol=1e-12 * np.abs(xj).max())


@pytest.mark.parametrize("name", sorted(_MATS))
def test_gate_matches_reference_device_path(monkeypatch, name):
    """float64, default options, gate on, the reference's jax backend:
    rcond to 1e-8, a plain well-conditioned result in both."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    aj, at = _pair(name)
    ref, port = _run_both(monkeypatch, aj, at, _rhs(at.n), jslu.Options(),
                          st.Options(), "jax")
    _assert_same(ref, port)
    x, lu, stats, _ = port[1]
    assert type(x) is np.ndarray and stats.escalations == 0
    assert 0.0 < stats.rcond < 1.0
    assert "estimated rcond" in stats.report()


# option set -> (env, Options fields)
_VARIANTS = {
    # a float32 factor with refinement cut: the berr ladder climbs to
    # float64, the re-gate estimates the escalated handle
    "f32_no_refine": ({}, {"factor_dtype": "float32",
                           "max_refine_steps": 0}),
    # every key ill-conditioned: the gate pre-climbs the ladder before
    # the first solve, and the result comes back stamped
    "ill_preclimb": ({"SLU_COND_STAMP": "0.9"},
                     {"factor_dtype": "float32"}),
    # the refuse mode turns the ill class into a typed refusal
    "refuse": ({"SLU_COND_STAMP": "0.9", "SLU_COND_POLICY": "refuse"},
               {}),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("name", sorted(_MATS))
def test_gate_decisions_match_reference(monkeypatch, name, variant):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    env, fields = _VARIANTS[variant]
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    aj, at = _pair(name)
    ref, port = _run_both(monkeypatch, aj, at, _rhs(at.n, 2),
                          jslu.Options(**fields), st.Options(**fields),
                          "host")
    _assert_same(ref, port)
    if variant == "refuse":
        assert port[0] == "refused"
    else:
        _, lu, stats, trig = port[1]
        assert stats.escalations == 1 and len(trig) == 1
        assert lu.effective_options.factor_dtype == "float64"
        if variant == "ill_preclimb":
            assert trig == ["ill_conditioned"]


def test_raised_floor_refuses_like_reference(monkeypatch):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    monkeypatch.setenv("SLU_COND_FLOOR", "0.5")
    aj, at = _pair("convdiff12")
    ref, port = _run_both(monkeypatch, aj, at, _rhs(at.n), jslu.Options(),
                          st.Options(), "host")
    _assert_same(ref, port)
    assert port[1][0] == "SingularMatrixError" and port[1][1] < 0.5


def _corpora():
    from superlu_dist_tpu.numerics import gauntlet as jg
    from superlu_dist_tpu_torch.numerics import gauntlet as tg
    return ({c["name"]: c for c in jg.corpus()},
            {c["name"]: c for c in tg.corpus()})


_CASES = ["kappa_base", "kappa_1e6", "kappa_1e10", "kappa_1e14",
          "kappa_inv_eps", "zero_row", "zero_col", "duplicated_rows",
          "wild_scaling", "indefinite", "nan_poisoned_a", "inf_poisoned_b",
          "dim_mismatch", "empty_rhs"]


@pytest.mark.parametrize("case", _CASES)
def test_gauntlet_case_matches_reference(monkeypatch, case):
    """The port's corpus equals the reference's, and each case has the
    reference's outcome (its host backend), never a silent wrong answer
    or an untyped failure."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu.numerics import gauntlet as jg
    from superlu_dist_tpu_torch.numerics import gauntlet as tg
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    cj, ct = _corpora()
    assert list(ct) == _CASES and list(cj) == _CASES
    a_j, a_t = cj[case]["a"], ct[case]["a"]
    np.testing.assert_array_equal(a_t.data, a_j.data)
    np.testing.assert_array_equal(ct[case]["b"], cj[case]["b"])
    rj = jg.classify(cj[case], lambda a, b: jslu.gssvx(
        None, a, b, backend="host")[0])
    rt = tg.classify(ct[case], lambda a, b: st.gssvx(
        None, a, b, device="cpu")[0])
    assert rt["outcome"] == rj["outcome"], (rt, rj)
    assert rt.get("error") == rj.get("error")
    assert rt["outcome"] not in ("silent_wrong", "untyped")
    if "rcond" in rj:
        assert abs(rt["rcond"] - rj["rcond"]) <= 1e-8 * rj["rcond"]
    if "perturbation" in rj:
        assert rt["perturbation"] == rj["perturbation"]


def test_run_gauntlet_summary_matches_reference():
    """The summary and its gate, on a run that answers every case with
    a typed refusal (the counting, not the solver)."""
    from superlu_dist_tpu.numerics import gauntlet as jg
    from superlu_dist_tpu.numerics.errors import InvalidInputError as JIE
    from superlu_dist_tpu_torch.numerics import gauntlet as tg
    from superlu_dist_tpu_torch.numerics.errors import InvalidInputError

    def refuse_t(a, b):
        raise InvalidInputError("no")

    def refuse_j(a, b):
        raise JIE("no")

    recs_t, sum_t = tg.run_gauntlet(refuse_t)
    recs_j, sum_j = jg.run_gauntlet(refuse_j)
    assert sum_t == sum_j and sum_t["gate"]["passed"]
    assert [r["outcome"] for r in recs_t] == ["refused_typed"] * 14

    def untyped(a, b):
        raise KeyError("x")

    _, bad = tg.run_gauntlet(untyped)
    assert bad["gate"] == {"silent_wrong": 0, "untyped": 14,
                           "passed": False}


@pytest.mark.parametrize("gate", ["on", "off"])
def test_norowperm_hard_case_is_refused_or_stamped(monkeypatch, gate):
    """random_unsymmetric(150, density=0.03) under NOROWPERM, float64,
    nrhs 3 (147 of 150 diagonal entries zero): pivot growth past 1e119
    overflows the port's factors.  With the gate on it is refused with a
    typed error, as the reference refuses it; with the gate off the
    perturbation ledger still stamps it.  Never a plain result."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu.numerics.errors import SingularMatrixError as JS
    from superlu_dist_tpu_torch.numerics.errors import NumericalError
    from superlu_dist_tpu_torch.numerics.ledger import PerturbedResult
    from superlu_dist_tpu_torch.utils.testmat import random_unsymmetric
    a = random_unsymmetric(150, density=0.03)
    b = _rhs(a.n, 3)
    opts = st.Options(row_perm=st.RowPerm.NOROWPERM)
    if gate == "on":
        monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
        with pytest.raises(NumericalError) as e:
            st.gssvx(opts, a, b, device="cpu")
        assert e.value.rcond is not None and e.value.rcond <= EPS
        # the reference refuses the same input (rcond ~2.4e-162)
        from superlu_dist_tpu.utils.testmat import random_unsymmetric as jr
        with pytest.raises(JS):
            jslu.gssvx(jslu.Options(row_perm=jslu.RowPerm.NOROWPERM),
                       jr(150, density=0.03), b, backend="host")
        return
    x, lu, stats = st.gssvx(opts, a, b, device="cpu")
    assert isinstance(x, PerturbedResult)
    assert x.ledger is lu.ledger and lu.ledger.count == stats.tiny_pivots > 0


def test_factored_rung_reuses_the_gated_rcond(monkeypatch):
    """A second gated solve on the same handle (Fact.FACTORED) reads the
    cached rcond: no estimator solve, the same stamp decision."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.numerics import gscon
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    _, at = _pair("convdiff12")
    b = _rhs(at.n)
    x, lu, stats = st.gssvx(st.Options(), at, b, device="cpu")
    r = lu.rcond
    assert r is not None and stats.rcond == r

    def no_estimate(*a, **k):
        raise AssertionError("the FACTORED rung re-estimated rcond")

    monkeypatch.setattr(gscon, "estimate_rcond", no_estimate)
    x2, lu2, s2 = st.gssvx(st.Options(fact=st.Fact.FACTORED), at, 2 * b,
                           lu=lu)
    assert lu2.device_lu is lu.device_lu and lu2.rcond == r == s2.rcond
    assert type(x2) is np.ndarray
    np.testing.assert_allclose(x2, 2 * x, rtol=1e-12)
