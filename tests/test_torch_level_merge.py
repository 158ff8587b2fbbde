"""Level merging (SLU_LEVEL_MERGE=1, ops/batched.build_schedule): the
port against the JAX package on the same plans.

Integer outputs equal the reference's exactly: every group, member,
batch size, slab offset and stride, and every index map of the
schedule and of its solve layout.  Solutions: gssvx on a merged
schedule agrees with the unmerged one to 1e-10 relative in max-norm
(both refined to float64 rounding, the float32 factor too), with equal
tiny-pivot counts, and with the reference's merged gssvx to the same
1e-10."""

import numpy as np
import pytest

from torch_port_util import jax_plan, ported_plan, rel_maxnorm

# (generator, args, kwargs) of the schedule-parity matrices
MERGE_MATRICES = {
    "lap3d6": ("laplacian_3d", (6,), {}),
    "convdiff12": ("convection_diffusion_2d", (12,), {}),
    "randunsym150": ("random_unsymmetric", (150,), {"density": 0.03}),
    "helmholtz12": ("helmholtz_2d", (12,), {}),
}


def _pair(name):
    from superlu_dist_tpu.utils import testmat as jtm
    from superlu_dist_tpu_torch.utils import testmat as ttm
    fn, args, kw = MERGE_MATRICES[name]
    aj, at = getattr(jtm, fn)(*args, **kw), getattr(ttm, fn)(*args, **kw)
    assert np.array_equal(aj.data, at.data)
    return aj, at


def _merge(monkeypatch, limit="1.5"):
    monkeypatch.setenv("SLU_LEVEL_MERGE", "1")
    monkeypatch.setenv("SLU_LEVEL_MERGE_LIMIT", limit)


@pytest.mark.parametrize("limit", ["1.5", "1e9"])
@pytest.mark.parametrize("name", sorted(MERGE_MATRICES))
def test_merged_schedule_matches_reference(name, limit, monkeypatch):
    """The merged schedule and its solve layout equal the reference's
    integer for integer, child slab strides included; merging leaves
    fewer groups than the buckets (one per level at limit 1e9)."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu.ops import trisolve as jt
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.ops import trisolve as tt
    aj, _ = _pair(name)
    pj = jax_plan(aj)
    pt = ported_plan(pj)
    unmerged = tb.build_schedule(pt)
    _merge(monkeypatch, limit)
    sj, st = jb.build_schedule(pj, 1), tb.build_schedule(pt)
    assert len(st.groups) == len(sj.groups) <= len(unmerged.groups)
    if limit == "1e9":
        assert len(st.groups) == len({g.level for g in st.groups})
    assert (st.upd_total, st.upd_pad, st.L_total, st.U_total,
            st.Li_total, st.Ui_total) == (
        sj.upd_total, sj.upd_pad, sj.L_total, sj.U_total, sj.Li_total,
        sj.Ui_total)
    for gj, gt in zip(sj.groups, st.groups):
        assert (gt.level, gt.mb, gt.wb, gt.n_loc, gt.n_true,
                gt.upd_off_global, gt.L_off, gt.U_off, gt.Li_off,
                gt.Ui_off) == (gj.level, gj.mb, gj.wb, gj.n_loc,
                               gj.n_true, gj.upd_off_global, gj.L_off,
                               gj.U_off, gj.Li_off, gj.Ui_off)
        np.testing.assert_array_equal(gt.sup_ids, gj.sup_ids)
        np.testing.assert_array_equal(gt.sup_pos, gj.sup_pos)
        for f in ("a_src", "a_dst", "one_dst", "col_idx", "struct_idx"):
            np.testing.assert_array_equal(getattr(gt, f),
                                          getattr(gj, f)[0], err_msg=f)
        assert [(m[0], m[1]) for m in gt.ea_meta] == [
            (m[0], m[2]) for m in gj.ea_meta]
        for ht, hj in zip(gt.ea_hosts, gj.ea_hosts):
            # (slab offset, slab stride, front base, positions)
            for x, y in zip(ht, hj[:4]):
                np.testing.assert_array_equal(x, y[0])
        assert gt.eb_meta == tuple(gj.eb_meta)
        for ht, hj in zip(gt.eb_hosts, gj.eb_hosts):
            for x, y in zip(ht, hj):
                np.testing.assert_array_equal(x, y[0])
    tsj, tst = jt.build_trisolve(sj), tt.build_trisolve(st)
    assert (tst.y_total, tst.u_total, tst.segments) == (
        tsj.y_total, tsj.u_total, tsj.segments)
    np.testing.assert_array_equal(tst.final_idx, tsj.final_idx)
    for gj, gt in zip(tsj.groups, tst.groups):
        assert (gt.trim, gt.rtrim, gt.J, gt.y_off, gt.u_off) == (
            gj.trim, gj.rtrim, gj.J, gj.y_off, gj.u_off)
        for f in ("b_idx", "u_gidx", "xs_idx"):
            np.testing.assert_array_equal(getattr(gt, f),
                                          getattr(gj, f)[0], err_msg=f)


@pytest.mark.parametrize("staged", ["1", "0"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_merged_gssvx_matches_unmerged_and_reference(dtype, staged,
                                                     monkeypatch):
    """gssvx on lap3d6 at the unbounded limit (7 groups -> one per
    level, the cross-bucket case): merged against unmerged and against
    the reference's merged gssvx, on the staged and the whole-phase
    arm."""
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    aj, at = _pair("lap3d6")
    xt = np.random.default_rng(3).standard_normal(at.n)
    b = at.to_scipy() @ xt
    monkeypatch.setenv("SLU_STAGED", staged)
    x0, lu0, s0 = st.gssvx(st.Options(factor_dtype=dtype), at, b,
                           device="cpu")
    _merge(monkeypatch, "1e9")
    x1, lu1, s1 = st.gssvx(st.Options(factor_dtype=dtype), at, b,
                           device="cpu")
    xj, _, sj = jslu.gssvx(jslu.Options(factor_dtype=dtype), aj, b,
                           backend="jax")
    assert len(lu1.device_lu.schedule.groups) < len(
        lu0.device_lu.schedule.groups)
    assert rel_maxnorm(x1, x0) <= 1e-10
    assert rel_maxnorm(x1, np.asarray(xj)) <= 1e-10
    assert s1.tiny_pivots == s0.tiny_pivots == sj.tiny_pivots
    assert s1.berr <= 64 * np.finfo(np.float64).eps


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_solver_merged(dtype, monkeypatch):
    """make_fused_solver on a merged schedule: the unmerged step's x to
    1e-10, equal tiny counts, berr at float64 rounding."""
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops.batched import make_fused_solver
    _, at = _pair("convdiff12")
    plan = st.plan_factorization(at, device="cpu")
    b = at.to_scipy() @ np.random.default_rng(4).standard_normal(
        (at.n, 2))
    x0, _, _, t0, _ = make_fused_solver(plan, dtype)(at.data, b)
    _merge(monkeypatch, "1e9")
    step = make_fused_solver(plan, dtype)
    x1, berr, _, t1, z1 = step(at.data, b)
    assert len(step.context.sched.groups) == len(
        {g.level for g in step.context.sched.groups})
    assert rel_maxnorm(x1.numpy(), x0.numpy()) <= 1e-10
    assert int(t1) == int(t0) and int(z1) == 0
    assert float(berr) <= 64 * np.finfo(np.float64).eps
    assert isinstance(x1, torch.Tensor)


def test_coalesce_key_collision_drops_no_front():
    """Two greedy groups of one level can close with the same padded
    frame; they fold into one group (the reference's
    tests/test_level_merge.py case), at every limit, and each frame
    holds its members' true extents."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops.batched import _coalesce_buckets
    by_bucket = {(3, 12): [0, 1, 2], (4, 6): [3],
                 (4, 7): [4], (4, 13): [5]}
    for lim in (1.0, 1.2, 1.5, 2.0, 1e9):
        out = _coalesce_buckets(by_bucket, lim)
        assert out == jb._coalesce_buckets(by_bucket, lim)
        assert sorted(s for sl in out.values() for s in sl) == list(
            range(6))
        for (wb, mb), sl in out.items():
            for s in sl:
                owb, omb = next(k for k, v in by_bucket.items()
                                if s in v)
                assert wb >= owb and mb - wb >= omb - owb


def test_flag_flip_rebuilds_schedule(monkeypatch):
    """get_schedule caches one schedule per (merge, limit) key: a flip
    of SLU_LEVEL_MERGE or of its limit mid-process builds a fresh one,
    and flipping back returns the cached one; a factorization after
    the flip runs on the new schedule."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops.batched import get_schedule
    _, at = _pair("lap3d6")
    plan = st.plan_factorization(at, device="cpu")
    s0 = get_schedule(plan)
    assert get_schedule(plan) is s0
    _merge(monkeypatch, "1.5")
    s1 = get_schedule(plan)
    _merge(monkeypatch, "1e9")
    s2 = get_schedule(plan)
    assert len({id(s0), id(s1), id(s2)}) == 3
    assert len(s2.groups) < len(s1.groups) < len(s0.groups)
    lu = st.factorize(at, plan=plan, device="cpu")
    assert lu.device_lu.schedule is s2
    monkeypatch.setenv("SLU_LEVEL_MERGE", "0")
    assert get_schedule(plan) is s0
