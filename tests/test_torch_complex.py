"""Native complex systems (complex64 / complex128): the port against
the JAX package on the CPU, with the same numpy inputs.

The JAX package runs its jax backend with native complex storage
(SLU_COMPLEX_PAIR unset).  Covered:
  * the plan on complex input: permutations, etree, supernodes and the
    schedule's index maps equal the reference's;
  * the plain versions of K1–K3 in complex (K1 with phase-keeping tiny
    pivots and exact counts), and the real-factor / complex-rhs codec;
  * the factor slabs per group, and the solve on the reference's
    factors carried across with interop.lu_from_arrays;
  * gssvx: complex128, complex64 factor with complex128 refinement,
    TRANS, CONJ, a real system with a complex b, and the host backend
    against the torch backend;
  * the fused solver, the gate's rcond, and pddrive on a complex .mtx.
Floating tolerances are TOL of the matching real precision (1e-10 for
complex128, 1e-4 for complex64); berr ≤ 64·eps(float64) everywhere.
"""

import numpy as np
import pytest
import torch

from torch_port_util import TOL, flatten

EPS = np.finfo(np.float64).eps
BERR_MAX = 64 * EPS
C128, C64 = np.dtype(np.complex128), np.dtype(np.complex64)
CTOL = {C128: TOL[np.dtype(np.float64)], C64: TOL[np.dtype(np.float32)]}


def _rel(a, b) -> float:
    """max|a − b| / max|b| over complex values (0 when both vanish)."""
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    s = float(np.max(np.abs(b))) if b.size else 0.0
    d = float(np.max(np.abs(a - b))) if b.size else 0.0
    return d / s if s else d


def _relerr(x, xt) -> float:
    return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))


def _matrices(name):
    """(reference CSRMatrix, port CSRMatrix) of one complex test matrix,
    built from the same numpy arrays."""
    from superlu_dist_tpu.sparse import CSRMatrix as JCSR
    from superlu_dist_tpu_torch.sparse import CSRMatrix as TCSR
    from superlu_dist_tpu_torch.utils import testmat
    if name == "helm8":
        a = testmat.helmholtz_2d(8)
        data = a.data
    else:                                  # "cru80": complex values
        a = testmat.random_unsymmetric(80, density=0.05, seed=3)
        rng = np.random.default_rng(7)
        data = a.data * np.exp(2j * np.pi * rng.random(a.nnz))
    arrs = (a.m, a.n, a.indptr.copy(), a.indices.copy(), data.copy())
    return JCSR(*arrs), TCSR(*arrs)


def _xtrue(n, nrhs=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nrhs)) + 1j * rng.standard_normal((n, nrhs))
    return x[:, 0] if nrhs == 1 else x


def _plans(name):
    from superlu_dist_tpu import Options as JOptions
    from superlu_dist_tpu.plan.plan import plan_factorization as jplan
    from superlu_dist_tpu_torch import interop
    aj, at = _matrices(name)
    pj = jplan(aj, JOptions())
    return aj, at, pj, interop.plan_from_arrays(flatten(pj), device="cpu")


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("name", ["helm8", "cru80"])
def test_plan_on_complex_input_matches_reference(name):
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    aj, at, pj, _ = _plans(name)
    pt = st.plan_factorization(at, device="cpu")
    for f in ("perm_r", "perm_c", "post", "final_row", "final_col",
              "coo_rows", "coo_cols"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
    for f in ("xsup", "supno", "sparent", "levels"):
        np.testing.assert_array_equal(getattr(pt.frontal.sym.part, f),
                                      getattr(pj.frontal.sym.part, f),
                                      err_msg=f)
    assert _rel(pt.scaled_values(at), pj.scaled_values(aj)) < 1e-15
    sj, sp = jb.build_schedule(pj, 1), tb.build_schedule(pt)
    assert len(sp.groups) == len(sj.groups)
    for gj, gt in zip(sj.groups, sp.groups):
        assert (gt.mb, gt.wb, gt.n_loc) == (gj.mb, gj.wb, gj.n_loc)
        for f in ("a_src", "a_dst", "one_dst", "col_idx", "struct_idx"):
            np.testing.assert_array_equal(getattr(gt, f),
                                          getattr(gj, f)[0], err_msg=f)
        for ht, hj in zip(gt.ea_hosts, gj.ea_hosts):
            for x, y in zip(ht, hj):
                np.testing.assert_array_equal(x, y[0])
        for ht, hj in zip(gt.eb_hosts, gj.eb_hosts):
            for x, y in zip(ht, hj):
                np.testing.assert_array_equal(x, y[0])


# ------------------------------------------------- the plain K1–K3

def _complex_fronts(n, mb, dtype, seed, tiny_at=None, zero=False):
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal((n, mb, mb))
         + 1j * rng.standard_normal((n, mb, mb))).astype(dtype)
    F += mb * np.broadcast_to(np.eye(mb, dtype=dtype), F.shape)
    if tiny_at is not None:
        # front 0's row/col t decoupled, its pivot tiny with a phase
        # (or exactly zero)
        t = tiny_at
        F[0, t, :] = 0
        F[0, :, t] = 0
        F[0, t, t] = 0 if zero else 1e-12 * np.exp(0.7j)
    return F


@pytest.mark.parametrize("dtype", [C128, C64])
@pytest.mark.parametrize("case", ["plain", "tiny", "zero"])
def test_panel_lu_plain_complex_matches_reference(dtype, case):
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu_torch.ops.panel_lu import partial_lu_batch
    mb, wb, n, t = 48, 32, 3, 5
    F = _complex_fronts(n, mb, dtype, seed=mb + len(case),
                        tiny_at=None if case == "plain" else t,
                        zero=case == "zero")
    thresh = 0.0 if case == "plain" else 1e-6
    got, tg, zg = partial_lu_batch(torch.from_numpy(F.copy()), thresh,
                                   wb=wb)
    ref, tr, zr = jd.partial_lu_batch(
        jnp.asarray(F), jnp.asarray(thresh, dtype.char.lower()), wb=wb,
        pallas=False)
    assert _rel(got.numpy(), np.asarray(ref)) < CTOL[dtype]
    assert (int(tg), int(zg)) == (int(tr), int(zr))
    assert int(tg) == (0 if case == "plain" else 1) and int(zg) == 0
    if case != "plain":
        piv = complex(got[0, t, t])
        assert abs(abs(piv) - thresh) <= 1e-6 * thresh
        want = thresh if case == "zero" else thresh * np.exp(0.7j)
        assert abs(piv - want) <= 1e-5 * thresh


def test_panel_lu_complex_zero_pivot_counted():
    """thresh 0 (ReplaceTinyPivot=NO): an exact complex zero pivot is
    counted as zero, never replaced, in both packages."""
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu_torch.ops.panel_lu import partial_lu_batch
    F = _complex_fronts(2, 16, C128, seed=4, tiny_at=2, zero=True)
    _, tg, zg = partial_lu_batch(torch.from_numpy(F.copy()), 0.0, wb=8)
    _, tr, zr = jd.partial_lu_batch(jnp.asarray(F), jnp.float64(0.0),
                                    wb=8, pallas=False)
    assert (int(tg), int(zg)) == (int(tr), int(zr)) == (0, 1)


def _bucket(dtype, seed=2):
    """One element bucket: 5 real child records into 3 fronts of mb 12
    (some rows sentinels), 3 K-padding records whose slab lanes run
    past the slab, and a complex slab."""
    rng = np.random.default_rng(seed)
    n_pad, mb, rc_b, K, nreal = 3, 12, 6, 8, 5
    slab = (rng.standard_normal(400)
            + 1j * rng.standard_normal(400)).astype(dtype)
    so, st, db = (np.zeros(K, np.int64) for _ in range(3))
    pr = np.full((K, rc_b), mb, np.int64)
    fronts = [0, 0, 1, 2, 2]
    for k in range(nreal):
        rc = rc_b - (k % 2)
        so[k], st[k], db[k] = 40 * k, rc + 1, fronts[k] * mb * mb
        pr[k, :rc] = np.sort(rng.choice(mb, rc, replace=False))
    db[nreal:], so[nreal:], st[nreal:] = db[nreal - 1], 390, 7
    return n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr


@pytest.mark.parametrize("dtype", [C128, C64])
def test_ea_scatter_plain_complex_matches_reference(dtype):
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops.batched import GroupSpec
    from superlu_dist_tpu_torch.ops.ea_scatter import ea_scatter_add
    n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr = _bucket(dtype)
    g = GroupSpec(level=0, mb=mb, wb=mb, n_loc=3, n_true=3,
                  sup_ids=np.arange(3), sup_pos=np.arange(3),
                  a_src=np.zeros(1, np.int64),
                  a_dst=np.full(1, 3 * mb * mb, np.int64),
                  one_dst=np.full(1, 3 * mb * mb, np.int64),
                  ea_hosts=((so, st, db, pr),),
                  ea_meta=((rc_b, K, nreal),),
                  col_idx=np.zeros((3, mb), np.int64),
                  struct_idx=np.zeros((3, 0), np.int64),
                  upd_off_global=0, L_off=0, U_off=0, Li_off=0, Ui_off=0)
    (b,) = g.dev(torch.device("cpu")).ea
    F0 = _complex_fronts(n_pad, mb, dtype, seed=1)
    Ft = torch.from_numpy(F0.copy())
    ea_scatter_add(Ft, torch.from_numpy(slab), b)
    blocks = ((jnp.asarray(so), jnp.asarray(st), jnp.asarray(db),
               jnp.asarray(pr), jnp.asarray(pr)),)
    ref = jb._ea_add(jnp.asarray(F0.reshape(-1)), jnp.asarray(slab),
                     blocks, ((rc_b, rc_b, K, K),), mb=mb, n_pad=n_pad,
                     allow_pallas=False)
    assert _rel(Ft.numpy().reshape(-1), np.asarray(ref)) < CTOL[dtype]
    assert not np.array_equal(Ft.numpy(), F0)


@pytest.mark.parametrize("pdt,xdt", [(C128, C128), (C64, C64),
                                     (C64, C128),
                                     (np.dtype(np.float64), C128),
                                     (np.dtype(np.float32), C64)])
def test_lsum_plain_complex_matches_reference(pdt, xdt):
    """Complex panels against complex right-hand sides (the mixed lane
    promotes complex64 panels to complex128), and real panels against
    complex right-hand sides, the real factor's codec: a real panel
    applied to 2R real columns equals it applied to R complex ones."""
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import pallas_lsum
    from superlu_dist_tpu_torch.ops.lsum import (_as_real_columns,
                                                 lsum_panel)
    rng = np.random.default_rng(9)
    t, wb, mb, rtrim, R = 4, 8, 28, 16, 3

    def rand(*shape, dt):
        v = rng.standard_normal(shape)
        if np.dtype(dt).kind == "c":
            v = v + 1j * rng.standard_normal(shape)
        return v.astype(dt)

    Lp, Li, xb = rand(t, mb, wb, dt=pdt), rand(t, wb, wb, dt=pdt), \
        rand(t, wb, R, dt=xdt)
    tx = torch.from_numpy(xb)
    Y = torch.zeros(3 + t * wb + 1, R, dtype=tx.dtype)
    U = torch.zeros(5 + t * rtrim + 1, R, dtype=tx.dtype)
    lsum_panel(torch.from_numpy(Li), torch.from_numpy(Lp)[:, wb:, :], tx,
               Y, U, 3, 5, rtrim)
    y = Y[3:3 + t * wb].numpy().reshape(t, wb, R)
    u = U[5:5 + t * rtrim].numpy().reshape(t, rtrim, R)
    L21 = Lp[:, wb:wb + rtrim, :]
    yr, ur = pallas_lsum._oracle()(jnp.asarray(Li.astype(xdt)),
                                   jnp.asarray(L21.astype(xdt)),
                                   jnp.asarray(xb))
    tol = CTOL[C64 if C64 in (np.dtype(pdt), np.dtype(xdt))
               or pdt == np.float32 else C128]
    assert _rel(y, np.asarray(yr)) < tol and _rel(u, np.asarray(ur)) < tol
    if pdt.kind == "f":
        xr = _as_real_columns(tx)
        assert xr.shape == (t, wb, 2 * R) and xr.data_ptr() == tx.data_ptr()
        Yr = torch.zeros(t * wb, 2 * R, dtype=xr.dtype)
        Ur = torch.zeros(t * rtrim, 2 * R, dtype=xr.dtype)
        lsum_panel(torch.from_numpy(Li), torch.from_numpy(Lp)[:, wb:, :],
                   xr, Yr, Ur, 0, 0, rtrim)
        rtol = 10 * np.finfo(xr.numpy().dtype).eps
        assert _rel(torch.view_as_complex(Yr.view(t * wb, R, 2)),
                    Y[3:3 + t * wb]) < rtol
        assert _rel(torch.view_as_complex(Ur.view(t * rtrim, R, 2)),
                    U[5:5 + t * rtrim]) < rtol


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_panel_lu_launch_plan_complex(dtype):
    """K1's regimes by the complex itemsize: a front of at most 128 KiB
    runs whole in one CTA (mb 128 in complex64, mb 64 in complex128);
    every launch of the large regime fits a CTA's shared memory, with
    the complex lanes' 64 × 64 × 16 update tiles."""
    from superlu_dist_tpu_torch.ops import panel_lu as pl
    small = 128 if dtype == torch.complex64 else 64
    assert pl.launch_plan(3, small, 32, dtype).regime == "small"
    assert pl.launch_plan(3, small + 32, 32, dtype).regime == "large"
    for mb, wb in ((160, 64), (1024, 512), (6144, 512), (363, 96)):
        p = pl.launch_plan(2, mb, wb, dtype)
        assert p.regime == "large" and p.smem_bytes <= pl.SMEM_LIMIT
        assert p.grids[-1] == (-(-(mb - wb) // 64), -(-(mb - wb) // 64), 2)


# ------------------------------------------------ factors and solves

_JAX_FACTORS = {}


def _jax_factor(name, dtype):
    """(reference plan, port plan, scaled values, reference factors),
    computed once per process."""
    key = (name, np.dtype(dtype).str)
    if key not in _JAX_FACTORS:
        from superlu_dist_tpu.ops import batched as jb
        aj, at, pj, pt = _plans(name)
        scaled = pj.scaled_values(aj)
        _JAX_FACTORS[key] = (pj, pt, scaled, jb.factorize_device(
            pj, scaled, dtype=dtype))
    return _JAX_FACTORS[key]


@pytest.mark.parametrize("name,dtype", [("helm8", C64), ("cru80", C128)])
def test_factor_slabs_match_reference(name, dtype):
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.device import torch_dtype
    from superlu_dist_tpu_torch.ops import batched as tb
    from torch_port_util import jax_factor_arrays
    pj, pt, scaled, jlu = _jax_factor(name, dtype)
    lu = tb.factorize_device(pt, scaled, dtype=dtype, device="cpu")
    assert lu.tiny_pivots == int(jlu.tiny_pivots)
    ref = interop.lu_from_arrays(pt, jax_factor_arrays(jlu), dtype, "cpu")
    for gi, (pg, rg) in enumerate(zip(lu.panels, ref.panels)):
        for what, a, b in zip(("L", "U", "Li", "Ui"), pg, rg):
            assert a.dtype == b.dtype == torch_dtype(dtype)
            assert _rel(a.numpy(), b.numpy()) < CTOL[dtype], (gi, what)


def test_solve_on_reference_factors_matches_reference():
    """The reference's complex128 factors carried across with
    interop.lu_from_arrays, solved by both packages, NOTRANS and TRANS,
    with a complex and with a real right-hand side."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops import batched as tb
    from torch_port_util import jax_factor_arrays
    pj, pt, _, jlu = _jax_factor("cru80", C128)
    lu = interop.lu_from_arrays(pt, jax_factor_arrays(jlu), C128, "cpu")
    assert lu.dtype == C128
    b = _xtrue(pj.n, 2, seed=4)
    for trans in (False, True):
        js = jb.solve_device_trans if trans else jb.solve_device
        ts = tb.solve_device_trans if trans else tb.solve_device
        for rhs in (b, b.real.copy()):
            ref, got = js(jlu, rhs), ts(lu, rhs)
            assert got.dtype == C128 and got.shape == np.shape(ref)
            assert _rel(got, np.asarray(ref)) < CTOL[C128], trans


# --------------------------------------------------------------- gssvx

_LANES = {
    # lane: (matrix, options, nrhs)
    "c128": ("helm8", {}, 1),
    "c128_cru80": ("cru80", {}, 2),
    "mixed": ("helm8", {"factor_dtype": "float32"}, 1),
    "trans": ("cru80", {"trans": "TRANS"}, 1),
    "conj": ("cru80", {"trans": "CONJ"}, 1),
    "real_a_complex_b": ("real", {}, 2),
}


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_gssvx_complex_lanes_match_reference(lane):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import random_unsymmetric
    name, kw, nrhs = _LANES[lane]
    if name == "real":
        from superlu_dist_tpu.utils.testmat import random_unsymmetric as jr
        aj, at = jr(80, density=0.05, seed=3), random_unsymmetric(
            80, density=0.05, seed=3)
    else:
        aj, at = _matrices(name)
    xt = _xtrue(at.n, nrhs, seed=1)
    asp = at.to_scipy()
    trans = kw.get("trans", "NOTRANS")
    op = {"NOTRANS": asp, "TRANS": asp.T, "CONJ": asp.conj().T}[trans]
    b = op @ xt
    jkw = {k: (getattr(jslu.Trans, v) if k == "trans" else v)
           for k, v in kw.items()}
    tkw = {k: (getattr(st.Trans, v) if k == "trans" else v)
           for k, v in kw.items()}
    xj, lj, sj = jslu.gssvx(jslu.Options(**jkw), aj, b)
    xp, lp, sp = st.gssvx(st.Options(**tkw), at, b, device="cpu")
    xj, xp = np.asarray(xj), np.asarray(xp)
    assert xp.dtype == C128 and xp.shape == xt.shape
    assert sj.berr <= BERR_MAX and sp.berr <= BERR_MAX
    assert _relerr(xp, xt) <= 10 * max(_relerr(xj, xt), EPS)
    assert sp.tiny_pivots == sj.tiny_pivots
    fdt = lp.effective_options.factor_dtype
    assert fdt == lj.effective_options.factor_dtype
    assert fdt == {"mixed": "complex64", "real_a_complex_b": "float64"
                   }.get(lane, "complex128")
    if lane == "mixed":
        assert sp.refine_steps >= 1 and sp.escalations == 0


def test_host_backend_matches_torch_backend_complex():
    """The host backend (numpy multifrontal, phase-keeping tiny pivots)
    is the second oracle: same x, diag(U) and tiny counts as the torch
    backend on the CPU."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.models.gssvx import get_diag_u
    _, at = _matrices("cru80")
    b = at.to_scipy() @ _xtrue(at.n, 2, seed=6)
    opts = st.Options()
    xh, lh, sh = st.gssvx(opts, at, b, backend="host")
    xt, lt, stt = st.gssvx(opts, at, b, device="cpu")
    assert sh.berr <= BERR_MAX and stt.berr <= BERR_MAX
    assert _rel(np.asarray(xh), np.asarray(xt)) < 1e-12
    assert _rel(get_diag_u(lh), get_diag_u(lt)) < 1e-12
    assert get_diag_u(lt).dtype == C128
    assert sh.tiny_pivots == stt.tiny_pivots


def test_condition_gate_classifies_complex_like_reference(monkeypatch):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_COND_ESTIMATE", "1")
    aj, at = _matrices("cru80")
    b = at.to_scipy() @ _xtrue(at.n, seed=2)
    xj, lj, sj = jslu.gssvx(jslu.Options(), aj, b)
    x, lp, sp = st.gssvx(st.Options(), at, b, device="cpu")
    assert lp.rcond is not None and lj.rcond is not None
    assert abs(lp.rcond - lj.rcond) <= 1e-8 * lj.rcond
    assert type(x).__name__ == type(xj).__name__      # stamped alike
    assert sp.berr <= BERR_MAX and sp.escalations == sj.escalations


# ----------------------------------------------------- the fused solver

@pytest.mark.parametrize("dtype", [C128, C64])
def test_fused_solver_complex_matches_reference(dtype):
    import jax.numpy as jnp
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    aj, at, pj, pt = _plans("helm8")
    xt = _xtrue(at.n, 2, seed=3)
    b = at.to_scipy() @ xt
    rj = jb.make_fused_solver(pj, dtype=dtype)(jnp.asarray(aj.data),
                                               jnp.asarray(b))
    xp, bp, sp, tp, zp = tb.make_fused_solver(pt, dtype=dtype,
                                              device="cpu")(at.data, b)
    assert xp.dtype == torch.complex128
    assert float(bp) <= BERR_MAX and float(rj[1]) <= BERR_MAX
    assert _relerr(xp.numpy(), xt) <= 10 * max(
        _relerr(np.asarray(rj[0]), xt), EPS)
    assert (int(tp), int(zp)) == (int(rj[3]), int(rj[4])) == (0, 0)


def test_fused_step_complex_solves_the_system():
    """make_fused_step in complex128: factor-ordered b in, x out, the
    system's solution to rounding."""
    from superlu_dist_tpu_torch.ops import batched as tb
    _, at, _, pt = _plans("cru80")
    xt = _xtrue(at.n, 2, seed=8)
    b = at.to_scipy() @ xt
    bf = np.empty_like(b)
    bf[pt.final_row] = b * pt.row_scale[:, None]
    y = tb.make_fused_step(pt, C128, device="cpu")(pt.scaled_values(at),
                                                    bf)
    assert y.dtype == torch.complex128
    x = y.numpy()[pt.final_col] * pt.col_scale[:, None]
    assert _relerr(x, xt) < 1e-12


# ---------------------------------------------------------- pddrive

@pytest.mark.parametrize("extra", [[], ["--fused", "--dtype", "float32"],
                                   ["--trans", "CONJ", "-s", "2"]])
def test_pddrive_complex_mtx(tmp_path, capsys, extra):
    """A complex MatrixMarket file through the port's pddrive on the
    CPU, held to the reference's pddrive on the same file (its host
    backend: the same manufactured solution and checks)."""
    import scipy.io
    from superlu_dist_tpu.drivers import pddrive as jdrive
    from superlu_dist_tpu_torch.drivers import pddrive
    _, at = _matrices("cru80")
    p = tmp_path / "c.mtx"
    scipy.io.mmwrite(str(p), at.to_scipy())

    def run(main, argv):
        rc = main([str(p)] + argv)
        out = capsys.readouterr().out
        err = float(out.split("inf-norm error:")[1].split()[0])
        res = float(out.split("relative residual:")[1].split()[0])
        return rc, out, err, res

    jx = [a for a in extra if a != "--fused"]
    rcj, _, errj, _ = run(jdrive.main, jx + ["--backend", "host", "-q"])
    rc, out, err, res = run(pddrive.main, extra + ["--device", "cpu"])
    assert rc == rcj == 0
    assert "dtype=complex128" in out
    assert ("factor dtype mapped to complex64" in out) == (
        "float32" in extra)
    assert err <= max(10 * errj, 1e-12) and res < 1e-13
