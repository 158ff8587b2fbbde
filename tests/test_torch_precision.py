"""The precision subsystem (precision/policy.py, bfloat16 factors through
K1–K3's plain versions, the escalation ladder, the fused doubleword
solver), the port on the CPU against the JAX package on the same numpy
inputs.

Policy objects, ladders and residual-mode resolutions equal the
reference's exactly.  Solutions are held to classes, not bits: the
reference's fused doubleword loop is jitted, and its bfloat16 arithmetic
rounds after every operation where the port's rounds once per store.
Each tolerance is stated where it is used.  Environment changes go
through `monkeypatch`."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from torch_port_util import TOL, jax_plan, ported_plan, rel_maxnorm

EPS64 = float(np.finfo(np.float64).eps)
BF16_EPS = 2.0 ** -7


# -- the policy object, the ladder --------------------------------------

@pytest.mark.parametrize("residual", ["doubleword", "plain"])
def test_policy_apply_roundtrip_matches_reference(residual):
    from superlu_dist_tpu import PrecisionPolicy as JP
    from superlu_dist_tpu_torch import PrecisionPolicy as TP
    kw = dict(factor_dtype="bfloat16", residual=residual,
              target_dtype="float64")
    oj, ot = JP(**kw).apply(), TP(**kw).apply()
    for f in ("factor_dtype", "solve_dtype", "residual_mode",
              "refine_dtype"):
        assert getattr(ot, f) == getattr(oj, f)
    assert ot.iter_refine.name == oj.iter_refine.name
    assert TP.from_options(ot).residual.value \
        == JP.from_options(oj).residual.value
    with pytest.raises(TypeError):
        TP(factor_dtype="floaty128")


@pytest.mark.parametrize("case", ["single", "double", "doubleword",
                                  "bogus"])
def test_resolve_residual_mode_matches_reference(case):
    from superlu_dist_tpu import options as jo
    from superlu_dist_tpu.precision import policy as jp
    from superlu_dist_tpu_torch import options as to
    from superlu_dist_tpu_torch.precision import policy as tp
    kw = {"single": {"iter_refine": "SLU_SINGLE"},
          "double": {"iter_refine": "SLU_DOUBLE"},
          "doubleword": {"residual_mode": "doubleword"},
          "bogus": {"residual_mode": "bogus"}}[case]

    def opts(mod):
        return mod.Options(**{k: (mod.IterRefine[v] if k == "iter_refine"
                                  else v) for k, v in kw.items()})
    if case == "bogus":
        for m, o in ((jp, opts(jo)), (tp, opts(to))):
            with pytest.raises(ValueError, match="unknown residual_mode"):
                m.resolve_residual_mode(o)
        return
    assert tp.resolve_residual_mode(opts(to)) \
        == jp.resolve_residual_mode(opts(jo))


@pytest.mark.parametrize("value", [None, "doubleword", "plain"])
def test_prec_residual_env_is_the_default(monkeypatch, value):
    """SLU_PREC_RESIDUAL is Options.residual_mode's default, read when
    an Options is made, in both packages."""
    from superlu_dist_tpu import Options as JO
    from superlu_dist_tpu_torch import Options as TO
    if value is None:
        monkeypatch.delenv("SLU_PREC_RESIDUAL", raising=False)
    else:
        monkeypatch.setenv("SLU_PREC_RESIDUAL", value)
    assert TO().residual_mode == JO().residual_mode == (value or "auto")


@pytest.mark.parametrize("env", [None, "float64, float32",
                                 "float64,bfloat16,float32"])
def test_ladder_matches_reference(monkeypatch, env):
    """The default ladder and SLU_PREC_LADDER overrides (shuffled ones
    sorted by eps), with the rungs each climbs through."""
    from superlu_dist_tpu.precision import policy as jp
    from superlu_dist_tpu_torch.precision import policy as tp
    if env is None:
        monkeypatch.delenv("SLU_PREC_LADDER", raising=False)
    else:
        monkeypatch.setenv("SLU_PREC_LADDER", env)
    assert tp.ladder() == jp.ladder()
    for d in ("bfloat16", "float16", "float32", "float64"):
        for c in ("float32", "float64"):
            assert tp.next_factor_dtype(d, ceiling=c) \
                == jp.next_factor_dtype(d, ceiling=c)
    if env is None:
        assert tp.ladder() == ("bfloat16", "float32", "float64")
        assert tp.next_factor_dtype("bfloat16") == "float32"


@pytest.mark.parametrize("target", ["float64", "float32"])
def test_ladder_policies_and_lower_rungs_match_reference(target):
    from superlu_dist_tpu.precision import policy as jp
    from superlu_dist_tpu_torch.precision import policy as tp
    pj, pt = jp.ladder_policies(target), tp.ladder_policies(target)
    assert [(p.factor_dtype, p.residual.value, p.target_dtype)
            for p in pt] == [(p.factor_dtype, p.residual.value,
                              p.target_dtype) for p in pj]
    assert tp.lower_rungs(target) == jp.lower_rungs(target)


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float32",
                                  "float64", "complex64"])
def test_dtype_info_matches_reference_finfo(name):
    """device.dtype_info: eps and bytes per element of each name equal
    jnp.finfo / jnp.dtype's (which know bfloat16 through ml_dtypes)."""
    from superlu_dist_tpu_torch.device import dtype_info
    info = dtype_info(name)
    assert info.eps == float(jnp.finfo(jnp.dtype(name)).eps)
    assert info.itemsize == jnp.dtype(name).itemsize
    assert info.is_complex == (name == "complex64")
    assert dtype_info(info.torch) is info
    if name == "bfloat16":
        with pytest.raises(TypeError, match="ml_dtypes"):
            info.numpy
        assert info.working.numpy == np.float32
    else:
        assert dtype_info(np.dtype(name)) is info
        assert info.working is info


# -- the bfloat16 lanes' plain versions ---------------------------------

def test_bf16_partial_lu_plain_matches_reference():
    """K1's plain version in bfloat16 (factored in float32, rounded once
    per store) against the reference's bfloat16 partial LU (which rounds
    after every operation): within 4·eps(bf16) of max|F|, a couple of
    bfloat16 units in the last place, with the same tiny count."""
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu_torch.ops.panel_lu import partial_lu_batch
    for mb, wb, n in ((16, 8, 3), (64, 32, 2), (96, 64, 2)):
        rng = np.random.default_rng(mb + wb)
        F = rng.standard_normal((n, mb, mb)).astype(np.float32)
        F += mb * np.eye(mb, dtype=np.float32)
        Fb = torch.from_numpy(F).to(torch.bfloat16)
        got, t, z = partial_lu_batch(Fb.clone(), 1e-6, wb=wb)
        assert got.dtype == torch.bfloat16
        ref, tr, zr = jd.partial_lu_batch(
            jnp.asarray(Fb.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(1e-6, jnp.bfloat16), wb=wb, pallas=False)
        r = np.asarray(ref.astype(jnp.float32))
        assert rel_maxnorm(got.float().numpy(), r) <= 4 * BF16_EPS
        assert (int(t), int(z)) == (int(tr), int(zr))
        # the once-rounded float32 factorization, exactly
        want, _, _ = partial_lu_batch(Fb.float(), 1e-6, wb=wb)
        assert torch.equal(got, want.to(torch.bfloat16))


def test_bf16_ea_scatter_plain_matches_reference():
    """K2's plain version in bfloat16 (adds in float32, one rounding per
    store) against the reference's bfloat16 element lane: within
    4·eps(bf16) of max|F|."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops.ea_scatter import ea_scatter_add
    from test_torch_kernels import _bucket_data, _port_bucket
    n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr = _bucket_data(
        np.float32)
    F0 = np.random.default_rng(1).standard_normal(
        (n_pad, mb, mb)).astype(np.float32)
    F0b = torch.from_numpy(F0).to(torch.bfloat16)
    sb = torch.from_numpy(slab).to(torch.bfloat16)
    b = _port_bucket(so, st, db, pr, mb, nreal)
    Fb = F0b.clone()
    ea_scatter_add(Fb, sb, b)
    blocks = ((jnp.asarray(so), jnp.asarray(st), jnp.asarray(db),
               jnp.asarray(pr), jnp.asarray(pr)),)
    ref = jb._ea_add(jnp.asarray(F0b.float().numpy().reshape(-1),
                                 jnp.bfloat16),
                     jnp.asarray(sb.float().numpy(), jnp.bfloat16),
                     blocks, ((rc_b, rc_b, K, K),), mb=mb, n_pad=n_pad,
                     allow_pallas=False)
    r = np.asarray(ref.astype(jnp.float32))
    assert rel_maxnorm(Fb.float().numpy().reshape(-1), r) <= 4 * BF16_EPS


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_bf16_lsum_plain_matches_reference(rdt):
    """K3's plain version with bfloat16 panels and a promoted right-hand
    side (the bf16_f32 / bf16_f64 lanes) against the reference's
    oracle, which promotes the same way: to the right-hand side's
    tolerance (1e-4 float32, 1e-10 float64)."""
    from superlu_dist_tpu.ops import pallas_lsum
    from superlu_dist_tpu_torch.ops.lsum import lsum_panel
    rng = np.random.default_rng(21)
    t, wb, mb, rtrim, R = 5, 16, 56, 40, 4
    Lp = torch.from_numpy(rng.standard_normal((t, mb, wb))).to(
        torch.bfloat16)
    Li = torch.from_numpy(rng.standard_normal((t, wb, wb))).to(
        torch.bfloat16)
    xb = rng.standard_normal((t, wb, R)).astype(rdt)
    Y = torch.zeros(t * wb + 1, R, dtype=torch.from_numpy(xb).dtype)
    U = torch.zeros(t * rtrim + 1, R, dtype=Y.dtype)
    lsum_panel(Li, Lp[:, wb:, :], torch.from_numpy(xb), Y, U, 0, 0, rtrim)
    yr, ur = pallas_lsum._oracle()(
        jnp.asarray(Li.float().numpy(), jnp.bfloat16),
        jnp.asarray(Lp[:, wb:wb + rtrim, :].float().numpy(), jnp.bfloat16),
        jnp.asarray(xb))
    tol = TOL[np.dtype(rdt)]
    assert rel_maxnorm(Y[:t * wb].numpy().reshape(t, wb, R),
                       np.asarray(yr)) < tol
    assert rel_maxnorm(U[:t * rtrim].numpy().reshape(t, rtrim, R),
                       np.asarray(ur)) < tol


# -- the fused doubleword solver ----------------------------------------

@pytest.mark.parametrize("mat", ["lap2d12", "lap3d6"])
def test_fused_df64_matches_reference(mat):
    """make_fused_solver(residual_mode="doubleword") with float32
    factors on the same plan in both packages: the same mode and layout,
    berr at most DF64_EPS in both, and the port's error against x_true
    within 10x of the reference's (plus 1e-14: both sit at the df64
    class)."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.precision.doubleword import DF64_EPS
    fn, k = {"lap2d12": ("laplacian_2d", 12), "lap3d6": ("laplacian_3d",
                                                         6)}[mat]
    aj = getattr(jtm, fn)(k)
    pj = jax_plan(aj)
    pt = ported_plan(pj)
    xt = np.random.default_rng(1).standard_normal((aj.n, 1))
    b = aj.to_scipy() @ xt
    sj = jb.make_fused_solver(pj, dtype="float32",
                              residual_mode="doubleword")
    xj, bj, *_ = sj(jnp.asarray(aj.data), jnp.asarray(b))
    st = tb.make_fused_solver(pt, dtype="float32",
                              residual_mode="doubleword", device="cpu")
    x, berr, steps, tiny, nzero = st(aj.data, b)
    assert (st.residual_mode, st.spmv_layout) == (sj.residual_mode,
                                                  sj.spmv_layout)
    assert float(bj) <= DF64_EPS and float(berr) <= DF64_EPS
    ej = np.abs(np.asarray(xj) - xt).max()
    et = np.abs(x.numpy() - xt).max()
    assert et <= 10 * ej + 1e-14
    assert int(nzero) == 0 and int(steps) >= 1


@pytest.mark.parametrize("mat", ["lap2d12", "lap3d6"])
def test_fp32_doubleword_policy_within_10x_of_f64(mat):
    """The reference's acceptance case on the port's gssvx: an fp32
    factor under the doubleword policy (host loop: native float64
    accumulation) lands within 10x of the all-f64 berr, without an
    escalation, at relative error below 1e-12."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import (laplacian_2d,
                                                      laplacian_3d)
    a = laplacian_2d(12) if mat == "lap2d12" else laplacian_3d(6)
    xtrue = np.random.default_rng(1).standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    pol = st.PrecisionPolicy(factor_dtype="float32",
                             residual=st.ResidualMode.DOUBLEWORD)
    x, lu, s = st.gssvx(pol.apply(), a, b, device="cpu")
    x64, _, s64 = st.gssvx(st.Options(), a, b, device="cpu")
    assert s.escalations == 0
    assert s.berr <= 10 * max(s64.berr, EPS64)
    assert np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue) < 1e-12


# -- bfloat16 factors and the escalation ladder -------------------------

def _illcond(mod, n=40, spread=10, seed=0):
    """The reference's tests/test_precision_policy.py family: cond =
    10^spread by SVD synthesis, as each package's CSRMatrix."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -spread, n)
    return mod.csr_from_scipy(sp.csr_matrix(u @ np.diag(s) @ v.T))


def _port_hops(monkeypatch):
    """The escalation events the port's health seam receives."""
    from superlu_dist_tpu_torch.numerics import health
    events = []
    monkeypatch.setattr(health, "record",
                        lambda ev, **kw: events.append((ev, kw)))
    return events


def test_bf16_ladder_matches_reference(monkeypatch):
    """The reference's one-rung-at-a-time case (_illcond(spread=4,
    seed=3), max_refine_steps 16): a failing bfloat16 factor climbs to
    float32 first; the port ends at the reference's factor dtype after
    the same number of hops, at berr ≤ 64·eps(f64)."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu import obs
    aj, at = _illcond(jslu, spread=4, seed=3), _illcond(st, spread=4,
                                                         seed=3)
    b = aj.to_scipy() @ np.random.default_rng(4).standard_normal(aj.n)
    _, luj, sj = jslu.gssvx(jslu.Options(factor_dtype="bfloat16",
                                         max_refine_steps=16), aj, b)
    jhops = [(e["from_dtype"], e["to_dtype"]) for e in
             obs.HEALTH.snapshot()["escalation_events"][-sj.escalations:]]
    events = _port_hops(monkeypatch)
    _, lut, s = st.gssvx(st.Options(factor_dtype="bfloat16",
                                    max_refine_steps=16), at, b,
                         device="cpu")
    hops = [(kw["factor_dtype"], kw["to_dtype"]) for ev, kw in events
            if ev == "escalation"]
    assert hops[0] == jhops[0] == ("bfloat16", "float32")
    assert hops == jhops and s.escalations == sj.escalations
    assert lut.effective_options.factor_dtype \
        == luj.effective_options.factor_dtype
    assert s.berr <= 64 * EPS64


@pytest.mark.parametrize("fdt", ["bfloat16", "float32"])
def test_escalate_no_keeps_the_factor_dtype(fdt):
    """escalate=NO on an ill-conditioned system (spread 10): no climb,
    the factors stay at the requested dtype in both packages."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = _illcond(jslu, seed=5), _illcond(st, seed=5)
    b = aj.to_scipy() @ np.random.default_rng(6).standard_normal(aj.n)
    _, luj, sj = jslu.gssvx(jslu.Options(factor_dtype=fdt,
                                         escalate=jslu.YesNo.NO), aj, b)
    _, lut, s = st.gssvx(st.Options(factor_dtype=fdt,
                                    escalate=st.YesNo.NO), at, b,
                         device="cpu")
    assert s.escalations == sj.escalations == 0
    assert lut.effective_options.factor_dtype \
        == luj.effective_options.factor_dtype == fdt
    want = torch.bfloat16 if fdt == "bfloat16" else np.float32
    assert lut.device_lu.dtype == want


def test_bf16_solve_dtypes_match_reference():
    """A bfloat16 handle's sweep dtype (solve_rhs_dtype) is the
    reference's promotion of a float64 right-hand side, and the port's
    factor slabs are bfloat16."""
    import importlib

    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    jg = importlib.import_module("superlu_dist_tpu.models.gssvx")
    tg = importlib.import_module("superlu_dist_tpu_torch.models.gssvx")
    a = laplacian_2d(6)
    opts = dict(factor_dtype="bfloat16")
    jlu = jslu.factorize(jslu.csr_from_scipy(a.to_scipy()),
                         jslu.Options(**opts))
    tlu = st.factorize(a, st.Options(**opts), device="cpu")
    assert tg.solve_rhs_dtype(tlu) == jg.solve_rhs_dtype(jlu) == np.float64
    assert all(f.dtype == torch.bfloat16 for f in tlu.device_lu.flats())
    assert st.query_space(tlu)["lu_bytes"] == tlu.plan.lu_nnz() * 2


def test_bf16_host_backend_refused():
    """The host backend is numpy, which has no bfloat16 without
    ml_dtypes: a typed ValueError naming the reason."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    a = laplacian_2d(5)
    with pytest.raises(ValueError, match="no bfloat16"):
        st.gssvx(st.Options(factor_dtype="bfloat16"), a, np.ones(a.n),
                 backend="host")


def test_bf16_gssvx_runs_without_ml_dtypes():
    """A bfloat16 gssvx (device="cpu") and the fused doubleword solver
    in a process where ml_dtypes cannot be imported (and JAX is never
    loaded): the port needs no numpy bfloat16."""
    code = r"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np
import superlu_dist_tpu_torch as st
from superlu_dist_tpu_torch.ops.batched import make_fused_solver
from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
a = laplacian_2d(10)
xt = np.random.default_rng(0).standard_normal(a.n)
x, lu, s = st.gssvx(st.Options(factor_dtype="bfloat16"), a,
                    a.to_scipy() @ xt, device="cpu")
assert lu.effective_options.factor_dtype == "bfloat16"
assert s.berr <= 64 * np.finfo(np.float64).eps, s.berr
plan = st.plan_factorization(a, st.Options(factor_dtype="float32"),
                             device="cpu")
step = make_fused_solver(plan, "bfloat16", residual_mode="doubleword")
xf, berr, *_ = step(a.data, (a.to_scipy() @ xt)[:, None])
assert float(berr) <= 2.0 ** -44, float(berr)
assert "jax" not in sys.modules and sys.modules["ml_dtypes"] is None
print("ok", float(abs(x - xt).max()))
"""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")
