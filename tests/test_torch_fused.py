"""Refinement on the device: the ELL residual SpMV (ops/spmv.py) and the
fused solver (ops/batched.py make_fused_step, make_fused_solver),
the port on the CPU against the JAX package, on the same numpy inputs.

Integer outputs — the ELL index planes, the layout and residual-mode
decisions, steps, tiny and zero-pivot counts — equal the reference's
exactly; solutions agree to 1e-10 relative in max-norm (1e-4 where
the refinement itself runs in float32); products to rtol 1e-12.  The
JAX results are computed once per module (its fused programs compile
in seconds each)."""

import numpy as np
import pytest
import torch

from torch_port_util import (MATRICES, TOL, jax_plan, matrix_pair,
                             ported_plan, rel_maxnorm)

EPS = np.finfo(np.float64).eps
BERR_MAX = 64 * EPS
# the parity matrices plus laplacian_2d(12)
FUSED_MATRICES = dict(MATRICES, lap2d12=("laplacian_2d", (12,), {}))


def _pair(name):
    """The same matrix from both packages' generators."""
    if name in MATRICES:
        return matrix_pair(name)
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    fn, args, kw = FUSED_MATRICES[name]
    return getattr(jtm, fn)(*args, **kw), getattr(ttm, fn)(*args, **kw)


def _odd_pair(kind):
    """laplacian_2d(6) with row 5 emptied ("empty") or row 0 made dense
    ("dense"), as a CSRMatrix of each package."""
    import scipy.sparse as sp
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    a = laplacian_2d(6).to_scipy().tolil()
    if kind == "empty":
        a[5, :] = 0
    else:
        a[0, :] = np.arange(1.0, a.shape[1] + 1.0)
    a = sp.csr_matrix(a)
    a.eliminate_zeros()
    return jslu.csr_from_scipy(a), st.csr_from_scipy(a)


def _rhs(n, nrhs, seed=0):
    return np.random.default_rng(seed).standard_normal((n, nrhs))


# --------------------------------------------------------------------
# ops/spmv.py
# --------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FUSED_MATRICES) + ["empty",
                                                           "dense"])
def test_ell_planes_equal_reference(name):
    from superlu_dist_tpu.ops import spmv as jsp
    from superlu_dist_tpu_torch.ops import spmv as tsp
    aj, at = (_odd_pair(name) if name in ("empty", "dense")
              else _pair(name))
    src_j, w_j = jsp.ell_from_csr(aj.indptr, aj.indices)
    src_t, w_t = tsp.ell_from_csr(at.indptr, at.indices)
    assert w_t == w_j
    assert src_t.dtype == np.int64 and np.array_equal(src_t, src_j)
    cols_j = jsp.ell_cols_from_src(src_j, aj.indices, aj.n)
    cols_t = tsp.ell_cols_from_src(src_t, at.indices, at.n)
    assert np.array_equal(cols_t, cols_j)
    # the device plane differs only at the pads, clamped to n − 1
    dev = tsp.device_cols(cols_t, at.n, "cpu").numpy()
    assert np.array_equal(dev, np.minimum(cols_j, at.n - 1))


@pytest.mark.parametrize("env", [{}, {"SLU_SPMV_LAYOUT": "ell"},
                                 {"SLU_SPMV_LAYOUT": "coo"},
                                 {"SLU_SPMV_LAYOUT": "auto",
                                  "SLU_SPMV_ELL_WASTE": "0.5"}])
@pytest.mark.parametrize("name", ["convdiff12", "empty", "dense"])
def test_spmv_layout_equals_reference(monkeypatch, env, name):
    from superlu_dist_tpu.ops import spmv as jsp
    from superlu_dist_tpu_torch.ops import spmv as tsp
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    aj, at = (_odd_pair(name) if name in ("empty", "dense")
              else _pair(name))
    lay_j = jsp.DeviceSpMV.build(aj).layout
    lay_t = tsp.DeviceSpMV.build(at, device="cpu").layout
    assert lay_t == lay_j
    _, w = tsp.ell_from_csr(at.indptr, at.indices)
    assert tsp.spmv_layout(at.nnz, at.n, w) == lay_j
    if name == "dense" and not env:
        assert lay_t == "coo"          # the dense row sends auto to COO
    if "SLU_SPMV_ELL_WASTE" in env:
        assert lay_t == "coo"


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("nrhs", [None, 1, 3])
@pytest.mark.parametrize("name", ["convdiff12", "empty"])
def test_device_spmv_matches_scipy_and_reference(monkeypatch, layout,
                                                 nrhs, name):
    """matvec and absmatvec against scipy and the reference's, at rtol
    1e-12 (nrhs None: a 1-D x)."""
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import spmv as jsp
    from superlu_dist_tpu_torch.ops import spmv as tsp
    monkeypatch.setenv("SLU_SPMV_LAYOUT", layout)
    aj, at = (_odd_pair(name) if name == "empty" else _pair(name))
    sp = at.to_scipy()
    x = _rhs(at.n, nrhs or 1, seed=3)
    if nrhs is None:
        x = x[:, 0]
    mj = jsp.DeviceSpMV.build(aj)
    mt = tsp.DeviceSpMV.build(at, device="cpu")
    assert mt.layout == mj.layout == layout
    xt = torch.from_numpy(x)
    y = mt.matvec(xt).numpy()
    ya = mt.absmatvec(xt.abs()).numpy()
    np.testing.assert_allclose(y, sp @ x, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(ya, abs(sp) @ np.abs(x), rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(mj.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        ya, np.asarray(mj.absmatvec(jnp.asarray(np.abs(x)))), rtol=1e-12)
    # new values on the same pattern, in place
    mt.load(2.0 * at.data)
    np.testing.assert_allclose(mt.matvec(xt).numpy(), 2.0 * (sp @ x),
                               rtol=1e-12, atol=1e-13)


def test_device_spmv_doubleword_names_item_11():
    """The doubleword operator of item 11 (ported): DeviceSpMV.build
    (doubleword=True) on convection_diffusion_2d(12) has the reference's
    layout and (hi, lo) ELL value planes, bit for bit, and matvec_df64
    equals the reference's run eagerly, hi and lo words, at nrhs 1 and
    3.  An operator built without the planes refuses matvec_df64 in
    both packages."""
    import jax
    import jax.numpy as jnp
    from superlu_dist_tpu.ops.spmv import DeviceSpMV as JSpMV
    from superlu_dist_tpu_torch.ops.spmv import DeviceSpMV
    from superlu_dist_tpu_torch.precision.doubleword import split_f64
    aj, at = _pair("convdiff12")
    mt = DeviceSpMV.build(at, device="cpu", doubleword=True)
    mj = JSpMV.build(aj, doubleword=True)
    assert mt.layout == mj.layout == "ell"
    for t, j in ((mt.ell_vals, mj.ell_vals),
                 (mt.ell_vals_lo, mj.ell_vals_lo)):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(j))
    rng = np.random.default_rng(3)
    for nrhs in (1, 3):
        xh, xl = split_f64(rng.standard_normal((at.n, nrhs)))
        with jax.disable_jit():
            yj = mj.matvec_df64(jnp.asarray(xh), jnp.asarray(xl))
        yt = mt.matvec_df64(torch.from_numpy(xh), torch.from_numpy(xl))
        for t, j in zip(yt, yj):
            assert np.array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))
    with pytest.raises(ValueError, match="doubleword=True"):
        DeviceSpMV.build(at, device="cpu").matvec_df64(
            torch.from_numpy(xh), torch.from_numpy(xl))
    with pytest.raises(ValueError, match="doubleword=True"):
        JSpMV.build(aj).matvec_df64(jnp.asarray(xh), jnp.asarray(xl))


# --------------------------------------------------------------------
# make_fused_step, make_fused_solver
# --------------------------------------------------------------------

_JAX = {}


def _plans(name, **opts):
    """(JAX plan, port plan, JAX matrix, port matrix); the port's plan
    is the JAX plan carried across, so both factor the same ordering."""
    from superlu_dist_tpu import Options
    from superlu_dist_tpu.plan.plan import plan_factorization
    aj, at = _pair(name)
    pj = (plan_factorization(aj, Options(**opts)) if opts
          else jax_plan(aj))
    return pj, ported_plan(pj), aj, at


def _jax_solve(key, pj, aj, b, **kw):
    """The reference's make_fused_solver result as numpy, cached per
    module under `key`."""
    if key not in _JAX:
        import jax.numpy as jnp
        from superlu_dist_tpu.ops import batched as jb
        step = jb.make_fused_solver(pj, **kw)
        out = step(jnp.asarray(aj.data), jnp.asarray(b))
        _JAX[key] = (tuple(np.asarray(o) for o in out),
                     step.residual_mode, step.spmv_layout)
    return _JAX[key]


def _port_solve(pt, at, b, **kw):
    from superlu_dist_tpu_torch.ops import batched as tb
    step = tb.make_fused_solver(pt, device="cpu", **kw)
    out = step(at.data, b)
    return tuple(o.numpy() for o in out), step


def _same(ref, got, berr_max=BERR_MAX):
    """x to its refine dtype's tolerance (1e-10 for float64), berr in
    class, steps and counts exactly."""
    (xj, bj, sj, tj, zj), (xt, bt, s_t, tt, zt) = ref, got
    assert xt.dtype == xj.dtype
    assert rel_maxnorm(xt, xj) <= TOL[xj.dtype]
    assert bj <= berr_max and bt <= berr_max
    assert (int(s_t), int(tt), int(zt)) == (int(sj), int(tj), int(zj))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("staged", [False, True])
def test_fused_solver_matches_reference_both_arms(monkeypatch, staged,
                                                  dtype):
    """laplacian_2d(12), nrhs 2: the staged and the whole-phase arm
    (SLU_STAGED forced in both packages), f64 and f32 factors with f64
    refinement."""
    monkeypatch.setenv("SLU_STAGED", "1" if staged else "0")
    pj, pt, aj, at = _plans("lap2d12")
    b = _rhs(at.n, 2)
    ref, mode, layout = _jax_solve(("lap2d12", staged, dtype), pj, aj, b,
                                   dtype=dtype)
    got, step = _port_solve(pt, at, b, dtype=dtype)
    _same(ref, got)
    assert step.context.staged == staged
    assert (step.residual_mode, step.spmv_layout) == (mode, layout)
    if dtype == "float32":
        assert int(got[2]) >= 1        # refinement ran


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fused_solver_matches_reference_f64(name):
    pj, pt, aj, at = _plans(name)
    b = _rhs(at.n, 1, seed=1)
    ref, _, _ = _jax_solve((name, "f64"), pj, aj, b, dtype="float64")
    got, _ = _port_solve(pt, at, b, dtype="float64")
    _same(ref, got)


# the reference's tests/test_fused.py decision cases: (plan options,
# make_fused_solver keywords, berr bound)
_DECISIONS = {
    "max_steps0": ({}, dict(dtype="float64", max_steps=0), BERR_MAX),
    "norefine": ({"iter_refine": "NOREFINE"}, dict(dtype="float64"),
                 BERR_MAX),
    "slu_single": ({"iter_refine": "SLU_SINGLE",
                    "factor_dtype": "float32"}, dict(dtype="float32"),
                   64 * float(np.finfo(np.float32).eps)),
    "plain": ({}, dict(dtype="float32", residual_mode="plain"),
              64 * float(np.finfo(np.float32).eps)),
    "fp64": ({}, dict(dtype="float32", residual_mode="fp64"), BERR_MAX),
}


@pytest.mark.parametrize("case", sorted(_DECISIONS))
def test_fused_decisions_match_reference(monkeypatch, case):
    """Each decision case on the staged arm of laplacian_2d(12): the
    same residual mode, refine dtype (x's dtype), steps and counts."""
    from superlu_dist_tpu.options import IterRefine
    monkeypatch.setenv("SLU_STAGED", "1")
    opts, kw, bound = _DECISIONS[case]
    opts = {k: (IterRefine[v] if k == "iter_refine" else v)
            for k, v in opts.items()}
    pj, pt, aj, at = _plans("lap2d12", **opts)
    b = _rhs(at.n, 1, seed=2)
    ref, mode, _ = _jax_solve(("decision", case), pj, aj, b, **kw)
    got, step = _port_solve(pt, at, b, **kw)
    _same(ref, got, bound)
    assert step.residual_mode == mode
    if case in ("max_steps0", "norefine"):
        assert int(got[2]) == 0


@pytest.mark.parametrize("case", ["f64_factor", "staged_default",
                                  "staged_explicit", "df64_lane"])
def test_doubleword_resolution_matches_reference(monkeypatch, case):
    """Where the reference resolves a double-word residual to fp64 the
    port does too; where it raises, the port raises the same error;
    where it runs its df64 lane (item 11, ported), the port runs its
    own: the same mode and layout, steps, tiny and zero-pivot counts,
    berr at most DF64_EPS in both, and x within 1e-10 of the
    reference's (relative max-norm; the reference's loop is jitted, so
    bits are not compared)."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.precision.doubleword import DF64_EPS
    monkeypatch.setenv("SLU_STAGED", "0")
    policy = case != "staged_explicit" and case != "df64_lane"
    pj, pt, aj, at = _plans("lap2d12", **({"residual_mode": "doubleword"}
                                          if policy else {}))
    kw = {"f64_factor": dict(dtype="float64"),
          "staged_default": dict(dtype="float32"),
          "staged_explicit": dict(dtype="float32", staged=True,
                                  residual_mode="doubleword"),
          "df64_lane": dict(dtype="float32",
                            residual_mode="doubleword")}[case]
    if case == "staged_default":
        monkeypatch.setenv("SLU_STAGED", "1")
    if case == "staged_explicit":
        with pytest.raises(ValueError, match="staged=False"):
            jb.make_fused_solver(pj, **kw)
        with pytest.raises(ValueError, match="staged=False"):
            tb.make_fused_solver(pt, device="cpu", **kw)
        return
    mode = jb.make_fused_solver(pj, **kw).residual_mode
    if case == "df64_lane":
        assert mode == "doubleword"
        b = _rhs(at.n, 1, seed=4)
        (xj, bj, sj, tj, zj), mj, lj = _jax_solve(("df64", case), pj, aj,
                                                  b, **kw)
        got, step = _port_solve(pt, at, b, **kw)
        xt, bt, s_t, tt, zt = got
        assert (step.residual_mode, step.spmv_layout) == (mj, lj)
        assert xt.dtype == xj.dtype == np.float64
        assert rel_maxnorm(xt, xj) <= TOL[xj.dtype]
        assert float(bj) <= DF64_EPS and float(bt) <= DF64_EPS
        assert (int(s_t), int(tt), int(zt)) == (int(sj), int(tj), int(zj))
        return
    assert mode == "fp64"
    assert tb.make_fused_solver(pt, device="cpu", **kw).residual_mode \
        == mode
    with pytest.raises(ValueError, match="fp64"):
        jb.make_fused_solver(pj, dtype="float64",
                             residual_mode="doubleword")
    with pytest.raises(ValueError, match="fp64"):
        tb.make_fused_solver(pt, dtype="float64",
                             residual_mode="doubleword", device="cpu")



def test_fused_step_matches_reference():
    """make_fused_step at f64: scaled values in plan COO order, b in
    factor ordering; x to 1e-10."""
    import jax
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    pj, pt, aj, at = _plans("convdiff12")
    vals = pj.scaled_values(aj)
    b = _rhs(at.n, 2, seed=4)
    jstep = jax.jit(jb.make_fused_step(pj, np.float64))
    xj = np.asarray(jstep(jnp.asarray(vals), jnp.asarray(b)))
    step = tb.make_fused_step(pt, np.float64, device="cpu")
    xt = step(vals, b).numpy()
    assert rel_maxnorm(xt, xj) <= 1e-10
    # a float32 factor promotes a float64 right-hand side
    x32 = tb.make_fused_step(pt, np.float32, device="cpu")(vals, b)
    assert x32.dtype == torch.float64
    assert rel_maxnorm(x32.numpy(), xj) <= 1e-4


def test_resid_fn_matches_reference():
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import batched as jb
    pj, pt, aj, at = _plans("randunsym200")
    rng = np.random.default_rng(5)
    b, x = rng.standard_normal((at.n, 2)), rng.standard_normal((at.n, 2))
    rj, bj = jb.make_fused_solver(pj, dtype="float64").resid_fn(
        jnp.asarray(aj.data), jnp.asarray(b), jnp.asarray(x))
    from superlu_dist_tpu_torch.ops import batched as tb
    rt, bt = tb.make_fused_solver(pt, dtype="float64",
                                  device="cpu").resid_fn(at.data, b, x)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12,
                               atol=1e-13)
    assert abs(float(bt) - float(bj)) <= 1e-12 * abs(float(bj))


def test_complex_names_item_10(monkeypatch):
    """Complex dtypes run natively, and under SLU_COMPLEX_PAIR=1 (pair
    storage, ROADMAP item 10b) make_fused_solver and make_fused_step
    factor a complex dtype on planes, to the native steps' x within
    1e-10 relative; a real step still refuses complex values."""
    from superlu_dist_tpu_torch.ops import batched as tb
    _, pt, _, at = _plans("lap2d12")
    step = tb.make_fused_solver(pt, dtype="float64", device="cpu")
    vals = at.data.astype(np.complex128) * (1 + 0.5j)
    b = _rhs(at.n, 1) + 1j * _rhs(at.n, 1, seed=1)
    bf = torch.from_numpy(b)
    native = [tb.make_fused_solver(pt, dtype=np.complex128,
                                   device="cpu")(vals, b)[0],
              tb.make_fused_step(pt, dtype=np.complex128,
                                 device="cpu")(vals, bf)]
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    pair = [tb.make_fused_solver(pt, dtype=np.complex128, device="cpu"),
            tb.make_fused_step(pt, dtype=np.complex128, device="cpu")]
    assert all(s.context.pair for s in pair)
    for x0, x1 in zip(native, (pair[0](vals, b)[0], pair[1](vals, bf))):
        x0, x1 = x0.numpy(), x1.numpy()
        assert np.max(np.abs(x1 - x0)) <= 1e-10 * np.max(np.abs(x0))
    with pytest.raises(TypeError, match="complex values"):
        step(at.data.astype(np.complex128), _rhs(at.n, 1))


def test_zero_pivot_returns_nzero_like_reference():
    """An exactly singular leading block with tiny-pivot replacement
    off: the fused solver returns its zero-pivot count, as the
    reference does, and raises nothing."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu.plan.plan import plan_factorization
    from superlu_dist_tpu_torch.ops import batched as tb
    m = sp.csr_matrix(np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0]]))
    aj = jslu.csr_from_scipy(m)
    opts = jslu.Options(replace_tiny_pivot=jslu.YesNo.NO,
                        equil=jslu.YesNo.NO,
                        row_perm=jslu.RowPerm.NOROWPERM)
    pj = plan_factorization(aj, opts)
    pt = ported_plan(pj)
    b = np.ones((3, 1))
    outj = jb.make_fused_solver(pj, dtype="float64", staged=False)(
        jnp.asarray(aj.data), jnp.asarray(b))
    outt = tb.make_fused_solver(pt, dtype="float64", staged=False,
                                device="cpu")(st.csr_from_scipy(m).data, b)
    assert int(outt[4]) == int(outj[4]) > 0
    assert int(outt[3]) == int(outj[3])
    assert int(outt[2]) == int(outj[2])


def test_second_call_reuses_the_context_and_held_factors_stay():
    """Calls of one step and of a second step on the same plan share one
    context, its solve programs and refinement state; a factorization
    held before the calls solves to the same bits after them; the
    schedule keeps one copy of its index sets."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched as tb
    _, pt, _, at = _plans("convdiff12")
    b = _rhs(at.n, 1, seed=6)
    lu = st.factorize(at, plan=pt, device="cpu")
    x0 = st.solve(lu, b[:, 0])
    step = tb.make_fused_solver(pt, dtype="float64", device="cpu")
    out1 = step(at.data, b)
    ctx = step.context
    sizes = (len(ctx._solvers), len(ctx._refinements))
    out2 = step(at.data * 1.5, b)
    out3 = tb.make_fused_solver(pt, dtype="float64", device="cpu")(
        at.data, b)
    assert tb.make_fused_solver(pt, dtype="float64",
                                device="cpu").context is ctx
    assert (len(ctx._solvers), len(ctx._refinements)) == sizes
    assert torch.equal(out1[0], out3[0])
    assert rel_maxnorm(out2[0].numpy(), out1[0].numpy() / 1.5) <= 1e-10
    assert np.array_equal(st.solve(lu, b[:, 0]), x0)
    assert all(list(g._dev) == ["cpu"] for g in ctx.sched.groups)


def test_resolve_device_gives_cuda_an_index(monkeypatch):
    from superlu_dist_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
