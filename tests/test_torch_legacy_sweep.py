"""The legacy level sweep (SLU_TRISOLVE=legacy, ops/trisolve.py
`_legacy_fwd` / `_legacy_bwd`): the port against its own packed sweep
and against the reference's legacy arm, on the same factorization.

Real systems: the legacy solve agrees with the packed solve and with
the reference's legacy solve to 1e-12 relative in max-norm in float64
(never bitwise: the two arms, and the two frameworks, sum the updates
in different orders), 1e-5 with a float32 factor.  Complex128 is held
to the reference's host backend, whose sweeps are numpy (the
reference's own complex sweeps are not an oracle on this host)."""

import numpy as np
import pytest
import torch

from torch_port_util import jax_plan, matrix_pair, ported_plan, rel_maxnorm

_REF = {}


def _factors(dtype, staged, monkeypatch):
    """(port handle, JAX handle, n) of convdiff12's plan, the same
    scaled values factored by both packages on the chosen arm."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    monkeypatch.setenv("SLU_STAGED", staged)
    aj, _ = matrix_pair("convdiff12")
    key = (dtype, staged)
    if key not in _REF:
        pj = jax_plan(aj)
        scaled = pj.scaled_values(aj)
        _REF[key] = (pj, jb.factorize_device(pj, scaled,
                                             dtype=np.dtype(dtype)),
                     scaled)
    pj, jlu, scaled = _REF[key]
    lu = tb.factorize_device(ported_plan(pj), scaled, dtype=dtype,
                             device="cpu")
    assert isinstance(lu, tb.StagedLU) == (staged == "1")
    return lu, jlu, pj.n


# (factor dtype, nrhs, trans, staged)
CASES = ([("float64", r, t, s) for r in (1, 8) for t in (False, True)
          for s in ("1", "0")]
         + [("float32", 1, False, "1"), ("float32", 8, True, "0")])


@pytest.mark.parametrize("dtype,nrhs,trans,staged", CASES)
def test_legacy_matches_packed_and_reference(dtype, nrhs, trans, staged,
                                             monkeypatch):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    lu, jlu, n = _factors(dtype, staged, monkeypatch)
    b = np.random.default_rng(nrhs).standard_normal((n, nrhs))
    solve = tb.solve_device_trans if trans else tb.solve_device
    jsolve = jb.solve_device_trans if trans else jb.solve_device
    packed = solve(lu, b)
    monkeypatch.setenv("SLU_TRISOLVE", "legacy")
    legacy = solve(lu, b)
    ref = np.asarray(jsolve(jlu, b))
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert legacy.shape == packed.shape == (n, nrhs)
    assert rel_maxnorm(legacy, packed) <= tol
    assert rel_maxnorm(legacy, ref) <= tol


def test_legacy_runs_no_k3_and_refuses_the_packed_sweep(monkeypatch):
    """The legacy arm's forward steps are batched products: K3's
    wrapper is never called on it (it is on the packed arm), and a
    packed sweep asked for under SLU_TRISOLVE=legacy raises instead of
    running in the legacy arm's place."""
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.ops import trisolve as tt
    lu, _, n = _factors("float64", "0", monkeypatch)
    calls = []
    real = tt.lsum_panel
    monkeypatch.setattr(tt, "lsum_panel",
                        lambda *a: (calls.append(1), real(*a)))
    b = np.ones(n)
    tb.solve_device(lu, b)
    assert calls
    calls.clear()
    monkeypatch.setenv("SLU_TRISOLVE", "legacy")
    tb.solve_device(lu, b)
    assert not calls
    with pytest.raises(RuntimeError, match="legacy"):
        tt.solve_packed(lu, torch.from_numpy(b[:, None]), False)


@pytest.mark.parametrize("trans", ["NOTRANS", "CONJ"])
def test_legacy_complex128_against_host_backend(trans, monkeypatch):
    """A complex128 gssvx with the legacy sweep (native complex) at
    nrhs 2 against the reference's host backend: x to 1e-12, equal
    tiny counts."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    aj, at = jtm.helmholtz_2d(12), ttm.helmholtz_2d(12)
    rng = np.random.default_rng(5)
    xt = rng.standard_normal((at.n, 2)) + 1j * rng.standard_normal(
        (at.n, 2))
    asp = at.to_scipy()
    b = (asp if trans == "NOTRANS" else asp.conj().T) @ xt
    monkeypatch.setenv("SLU_TRISOLVE", "legacy")
    x, _, s = st.gssvx(st.Options(trans=st.Trans[trans]), at, b,
                       device="cpu")
    xh, _, sh = jslu.gssvx(jslu.Options(trans=jslu.Trans[trans]), aj, b,
                           backend="host")
    assert x.dtype == np.complex128
    assert np.max(np.abs(x - xh)) <= 1e-12 * np.max(np.abs(xh))
    assert s.tiny_pivots == sh.tiny_pivots


def test_fused_solver_on_the_legacy_arm(monkeypatch):
    """The fused solver reads the arm per call: after a flip to legacy
    its refinement solves run the legacy programs (the context then
    holds the solve programs of both arms), to the merged call's x
    within 1e-12."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops.batched import make_fused_solver
    _, at = matrix_pair("convdiff12")
    plan = st.plan_factorization(at, device="cpu")
    b = at.to_scipy() @ np.random.default_rng(6).standard_normal(
        (at.n, 3))
    step = make_fused_solver(plan, "float64")
    x0 = step(at.data, b)[0]
    monkeypatch.setenv("SLU_TRISOLVE", "legacy")
    x1, berr, *_ = step(at.data, b)
    arms = {k[2] for k in step.context._solvers}
    assert arms == {"merged", "legacy"}
    assert rel_maxnorm(x1.numpy(), x0.numpy()) <= 1e-12
    assert float(berr) <= 64 * np.finfo(np.float64).eps
