"""Double-word (df64) arithmetic (precision/doubleword.py) and the df64
residual product (kernel K4's plain version, ops/df64_spmv.py), the
port on the CPU against the JAX package on the same numpy inputs.

The error-free transformations are held BITWISE (hi and lo words) to
the reference's functions run eagerly (`jax.disable_jit()`): the same
operations in the same order give the same bits.  Under jit XLA:CPU
contracts some of the reference's products (within its 2^-44 bound),
so nothing here compares against a jitted reference.  The COO lane and
the componentwise bound are held to the reference's own bounds, and
the fused doubleword context to its contract: no float64 tensor before
the final join."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superlu_dist_tpu.precision import doubleword as jdw
from superlu_dist_tpu_torch.precision import doubleword as tdw


def _bits_equal(t, j) -> bool:
    """Two float32 arrays equal bit for bit (signed zeros included)."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return (t.shape == j.shape and t.dtype == j.dtype == np.float32
            and np.array_equal(t.view(np.int32), j.view(np.int32)))


def _operands(n=4096, seed=0):
    """fp32 values over ten binades with signs, and df64 pairs built
    from them by the exact split."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n)
         * np.exp(rng.uniform(-5, 5, n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xh, xl = tdw.split_f64(rng.standard_normal(n)
                           * np.exp(rng.uniform(-3, 3, n)))
    yh, yl = tdw.split_f64(rng.standard_normal(n))
    return a, b, (xh, xl), (yh, yl)


def _both(name, *args):
    """`name` of both packages on the same numpy operands (tuples are
    df64 pairs), the reference run eagerly."""
    def conv(f):
        return lambda v: (tuple(f(u) for u in v) if isinstance(v, tuple)
                          else f(v))
    with jax.disable_jit():
        rj = getattr(jdw, name)(*map(conv(jnp.asarray), args))
    rt = getattr(tdw, name)(*map(conv(torch.from_numpy), args))
    return rt, rj


# 4096 random pairs per case
_CASES = {
    "two_sum": lambda a, b, x, y: (a, b),
    "quick_two_sum": lambda a, b, x, y: (a, (b * np.float32(1e-9))),
    "two_prod": lambda a, b, x, y: (a, b),
    "df_add": lambda a, b, x, y: (x, y),
    "df_sub": lambda a, b, x, y: (x, y),
    "df_neg": lambda a, b, x, y: (x,),
    "df_mul": lambda a, b, x, y: (x, y),
    "df_mul_f": lambda a, b, x, y: (x, b),
    "df_add_f": lambda a, b, x, y: (x, b),
    "df_axpy": lambda a, b, x, y: (y, x, y),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_eft_bitwise_vs_eager_reference(name):
    a, b, x, y = _operands()
    rt, rj = _both(name, *_CASES[name](a, b, x, y))
    assert len(rt) == len(rj) == 2
    assert all(_bits_equal(t, j) for t, j in zip(rt, rj))


def test_df_mul_f_scalar_bitwise():
    """A scalar multiplier (the reference's `_match_shapes` case)."""
    _, _, x, _ = _operands(seed=1)
    with jax.disable_jit():
        rj = jdw.df_mul_f(tuple(map(jnp.asarray, x)), np.float32(3.1))
    rt = tdw.df_mul_f(tuple(map(torch.from_numpy, x)),
                      torch.tensor(3.1, dtype=torch.float32))
    assert all(_bits_equal(t, j) for t, j in zip(rt, rj))


@pytest.mark.parametrize("what", ["df_sum", "df_dot"])
def test_df_sum_and_dot_bitwise(what):
    # 96 terms: the reference's scan runs op by op under disable_jit
    _, _, x, y = _operands(n=96, seed=2)
    if what == "df_sum":
        th = np.stack([x[0][:48], y[0][:48]], axis=1)
        tl = np.stack([x[1][:48], y[1][:48]], axis=1)
        with jax.disable_jit():
            rj = jdw.df_sum(jnp.asarray(th), jnp.asarray(tl), axis=0)
        rt = tdw.df_sum(torch.from_numpy(th), torch.from_numpy(tl), dim=0)
    else:
        rt, rj = _both("df_dot", x, y)
    assert all(_bits_equal(t, j) for t, j in zip(rt, rj))


def _ell(a):
    """(reference column plane with sentinel n, device plane clamped to
    n − 1, value hi plane, value lo plane) of a CSRMatrix."""
    from superlu_dist_tpu_torch.ops.spmv import (ell_cols_from_src,
                                                 ell_from_csr)
    src, _ = ell_from_csr(a.indptr, a.indices)
    cols = ell_cols_from_src(src, a.indices, a.n)
    vh, vl = tdw.split_f64(a.data)
    ext = [np.concatenate([v, np.zeros(1, np.float32)])[src]
           for v in (vh, vl)]
    return cols, np.minimum(cols, a.n - 1), ext[0], ext[1]


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("mat", ["lap2d12", "cd12"])
def test_df64_ell_spmv_bitwise_vs_reference(mat, nrhs):
    """The ELL lane on laplacian_2d(12) and convection_diffusion_2d(12)
    (w = 5): the same (hi, lo) words as the reference's eager lane (whose
    gather clamps the sentinel column n to n − 1, where the port's
    device plane already points)."""
    from superlu_dist_tpu_torch.utils.testmat import (
        convection_diffusion_2d, laplacian_2d)
    a = (laplacian_2d if mat == "lap2d12" else convection_diffusion_2d)(12)
    cols, dcols, vh, vl = _ell(a)
    xh, xl = tdw.split_f64(np.random.default_rng(5).standard_normal(
        (a.n, nrhs)))
    with jax.disable_jit():
        rj = jdw.df64_ell_spmv(*map(jnp.asarray, (cols, vh, vl, xh, xl)))
    rt = tdw.df64_ell_spmv(*map(torch.from_numpy, (dcols, vh, vl, xh, xl)))
    assert all(_bits_equal(t, j) for t, j in zip(rt, rj))


@pytest.mark.parametrize("nrhs", [None, 3])
def test_df64_ell_spmv_componentwise_bound(nrhs):
    """The reference's bound (tests/test_doubleword.py): w df64 terms
    through the compensated scan stay within 16·w·2^-48 of the float64
    product, componentwise over |A|·|x|."""
    rng = np.random.default_rng(12)
    n, w = 300, 9
    cols = rng.integers(0, n, (n, w))
    vals = rng.standard_normal((n, w))
    x = rng.standard_normal(n if nrhs is None else (n, nrhs))
    vh, vl = tdw.split_f64(vals)
    xh, xl = tdw.split_f64(x)
    yh, yl = tdw.df64_ell_spmv(*map(torch.from_numpy,
                                    (cols, vh, vl, xh, xl)))
    got = tdw.join_f64(yh.numpy(), yl.numpy())
    sub = "nw,nw->n" if nrhs is None else "nw,nwr->nr"
    ref = np.einsum(sub, vals, x[cols])
    den = np.einsum(sub, np.abs(vals), np.abs(x)[cols])
    assert np.max(np.abs(got - ref) / den) < 16 * w * 2.0 ** -48


def test_df64_coo_spmv_fp32_class_against_reference():
    """The COO lane: exact df64 terms, fp32-class row sums (the
    reference's bound, deg·eps32·4 componentwise), and within that
    bound of the reference's own COO lane."""
    rng = np.random.default_rng(13)
    n, deg = 200, 6
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, n * deg)
    vals = rng.standard_normal(n * deg)
    x = rng.standard_normal(n)
    vh, vl = tdw.split_f64(vals)
    xh, xl = tdw.split_f64(x)
    yh, yl = tdw.df64_coo_spmv(*map(torch.from_numpy,
                                    (rows, cols, vh, vl, xh, xl)), n=n)
    got = tdw.join_f64(yh.numpy(), yl.numpy())
    with jax.disable_jit():
        jh, jl = jdw.df64_coo_spmv(*map(jnp.asarray,
                                        (rows, cols, vh, vl, xh, xl)), n=n)
    ref = np.zeros(n)
    np.add.at(ref, rows, vals * x[cols])
    den = np.zeros(n)
    np.add.at(den, rows, np.abs(vals * x[cols]))
    bound = deg * np.finfo(np.float32).eps * 4
    assert np.max(np.abs(got - ref) / den) < bound
    assert np.max(np.abs(got - jdw.join_f64(jh, jl)) / den) < bound


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_split_join_roundtrip(form):
    """hi + lo reproduces float64 values to df64 class (2^-48 relative),
    hi is fl32(v), and the numpy split equals the reference's."""
    v = np.random.default_rng(7).standard_normal(1000) * 1e3
    if form == "numpy":
        hi, lo = tdw.split_f64(v)
        jh, jl = jdw.split_f64(v)
        assert np.array_equal(hi, jh) and np.array_equal(lo, jl)
        back = tdw.join_f64(hi, lo)
    else:
        hi, lo = tdw.split_f64_tensor(torch.from_numpy(v))
        assert hi.dtype == lo.dtype == torch.float32
        back = tdw.join_f64_tensor(hi, lo).numpy()
        hi = hi.numpy()
    assert np.array_equal(hi, v.astype(np.float32))
    assert np.max(np.abs(back - v) / np.abs(v)) < 2.0 ** -48


def test_k4_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors K4's wrapper runs the plain version (bitwise) and
    launches nothing; its bound counts int64 columns, two value planes
    and x's and y's two planes, and 44 flops a slot."""
    from superlu_dist_tpu_torch.ops import df64_spmv
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    a = laplacian_2d(8)
    _, dcols, vh, vl = _ell(a)
    xh, xl = tdw.split_f64(np.random.default_rng(9).standard_normal(
        (a.n, 2)))
    args = list(map(torch.from_numpy, (dcols, vh, vl, xh, xl)))
    before = df64_spmv.df64_ell_spmv.launches
    got = df64_spmv.df64_ell_spmv(*args)
    want = tdw.df64_ell_spmv(*args)
    assert df64_spmv.df64_ell_spmv.launches == before
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    flops, nbytes = df64_spmv.bound_work(110592, 7, 1)
    assert flops == 44 * 110592 * 7
    assert nbytes == 110592 * 7 * 16 + 4 * 4 * 110592


def test_df64_fused_context_holds_no_float64():
    """The fused doubleword solver's state on laplacian_2d(12), f32
    factor: every floating tensor of the refinement state, the operator
    and the factor buffers is float32 — the split happens as the
    inputs come in and the join after the loop — except K1's
    one-element threshold, which is the kernel's float64 argument, not
    data.  The steps before the join end in float32 pairs."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    a = laplacian_2d(12)
    plan = st.plan_factorization(a, st.Options(factor_dtype="float32"),
                                 device="cpu")
    step = tb.make_fused_solver(plan, dtype="float32",
                                residual_mode="doubleword")
    xt = np.random.default_rng(14).standard_normal((a.n, 1))
    x, berr, steps, _, _ = step(a.data, a.to_scipy() @ xt)
    assert x.dtype == torch.float64 and berr.dtype == torch.float32
    assert float(berr) <= tdw.DF64_EPS and int(steps) >= 1
    ctx = step.context
    (ref,) = ctx._refinements.values()
    assert isinstance(ref, tb._Df64Refinement)
    tensors = [v for obj in (ref, ref.spmv) for v in vars(obj).values()
               if isinstance(v, torch.Tensor)]
    buf = ctx.buf
    tensors += [buf.vals_ext, buf.upd, *buf.flats]
    floats = [t for t in tensors if t.is_floating_point()]
    assert len(floats) >= 20
    assert all(t.dtype == torch.float32 for t in floats)
    assert buf.thresh.dtype == torch.float64 and buf.thresh.numel() == 1
