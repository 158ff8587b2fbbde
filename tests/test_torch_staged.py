"""The compiled-program layer against the JAX package on the CPU: merged
factor and solve segments, the staged/whole-phase decision, the
DeviceLU slabs, both arms' solutions, get_diag_u, query_space and
warm_solve.

On the CPU every program body runs eagerly (ops/graphs.py captures only
on the card), so the staged and whole-phase arms run the same member
bodies in the same order and agree bit for bit.  Integer outputs
(segments, decisions, byte counts) equal the reference's exactly;
factors and solutions agree within 1e-10 relative in float64 and 1e-4
in float32 (the frameworks reduce GEMMs in different orders)."""

import numpy as np
import pytest
import torch

from torch_port_util import (MATRICES, TOL, jax_factor_arrays,
                             jax_factorization, jax_plan, matrix_pair,
                             ported_plan, rel_maxnorm)


def _schedules(name):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    aj, _ = matrix_pair(name)
    pj = jax_plan(aj)
    return jb.get_schedule(pj, 1), tb.get_schedule(ported_plan(pj))


@pytest.mark.parametrize("cells", [None, "0", "1", "65536"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_factor_segments_match_reference(name, cells, monkeypatch):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    if cells is not None:
        monkeypatch.setenv("SLU_FACTOR_MERGE_CELLS", cells)
    js, ts = _schedules(name)
    ref = jb.compute_factor_segments(js)
    assert tb.compute_factor_segments(ts) == ref
    assert tb.get_factor_segments(ts) == ref
    assert sorted(i for seg in ref for i in seg) == list(
        range(len(ts.groups)))
    assert tb.factor_merge_on() == jb.factor_merge_on()
    assert tb.factor_arm() == ("legacy" if cells == "0" else "merged")


def test_factor_segments_cap(monkeypatch):
    """A small segment budget splits chains where the reference does."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    monkeypatch.setenv("SLU_FACTOR_SEG_CELLS", "20000")
    js, ts = _schedules("lap3d6")
    ref = jb.compute_factor_segments(js)
    assert tb.compute_factor_segments(ts) == ref
    assert max(len(s) for s in ref) > 1 and len(ref) > 2


@pytest.mark.parametrize("cells", [None, "0", "4096"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_trisolve_segments_match_reference(name, cells, monkeypatch):
    from superlu_dist_tpu.ops import trisolve as jt
    from superlu_dist_tpu_torch.ops import trisolve as tt
    if cells is not None:
        monkeypatch.setenv("SLU_TRISOLVE_MERGE_CELLS", cells)
    js, ts = _schedules(name)
    ref = jt.build_trisolve(js).segments
    got = tt.get_trisolve(ts)
    assert got.segments == ref
    assert tt.merge_cells_limit() == jt.merge_cells_limit()
    assert tt.seg_cells_limit() == jt.seg_cells_limit()
    # the segment metas key the same members the reference's do
    jts = jt.get_trisolve(js)
    for seg in ref:
        assert tt.seg_metas(got, seg) == jt.seg_metas(jts, seg, False)


@pytest.mark.parametrize("staged,min_groups", [
    ("0", None), ("1", None), ("auto", None), (None, None),
    ("auto", "3"), (None, "400"), ("off", "3"), ("on", "400")])
def test_staged_enabled_matches_reference(staged, min_groups,
                                          monkeypatch):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    for var, val in (("SLU_STAGED", staged),
                     ("SLU_STAGED_MIN_GROUPS", min_groups)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    for name in sorted(MATRICES):
        js, ts = _schedules(name)
        assert tb.staged_enabled(ts) == jb.staged_enabled(js), name


def test_factor_seg_metas_carry_the_k1_regime():
    """The last leg of a segment meta is the port's K1 regime, the
    other legs are the reference's."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.ops import panel_lu
    js, ts = _schedules("convdiff12")
    for seg in tb.get_factor_segments(ts):
        for dt, tdt in ((np.float64, torch.float64),
                        (np.float32, torch.float32)):
            got = tb.factor_seg_metas(ts, seg, dt)
            ref = jb.factor_seg_metas(js, seg, dt)
            # (mb, wb, n_loc) and eb_meta as the reference's; the
            # port's ea_meta is (rc_b, K, nreal) per bucket where the
            # reference's is (rc_b, tc_b, K, C)
            assert [m[:3] + m[4:5] for m in got] == [
                m[:3] + m[4:5] for m in ref]
            assert [[(rc, K) for rc, K, _ in m[3]] for m in got] == [
                [(rc, K) for rc, _, K, _ in m[3]] for m in ref]
            assert [m[5] for m in got] == [
                panel_lu.launch_plan(n, mb, wb, tdt).regime
                for mb, wb, n, *_ in got]


def _port_lu(name, dtype, staged, monkeypatch):
    """The port's factors of a parity matrix on the CPU, by one arm."""
    from superlu_dist_tpu_torch.ops import batched as tb
    # the reference's factors by its default (whole-phase) arm
    monkeypatch.delenv("SLU_STAGED", raising=False)
    pj, jlu, scaled = jax_factorization(name, dtype)
    monkeypatch.setenv("SLU_STAGED", "1" if staged else "0")
    pt = ported_plan(pj)
    lu = tb.factorize_device(pt, scaled, dtype=dtype, device="cpu")
    assert isinstance(lu, tb.StagedLU if staged else tb.DeviceLU)
    return pt, lu, jlu


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name,dtype", [
    (name, np.float64) for name in sorted(MATRICES)] + [
    ("lap3d6", np.float32), ("convdiff12", np.float32)])
def test_device_lu_flats_match_reference(name, dtype, staged,
                                         monkeypatch):
    """Both arms' slabs against the reference's whole-phase DeviceLU
    flats: equal lengths and offsets, values within the tolerance,
    equal tiny-pivot counts."""
    pt, lu, jlu = _port_lu(name, dtype, staged, monkeypatch)
    ref = jax_factor_arrays(jlu)
    sched = lu.schedule
    assert [len(f) for f in ref] == [sched.L_total, sched.U_total,
                                     sched.Li_total, sched.Ui_total]
    jsched = jlu.schedule
    for g, jg in zip(sched.groups, jsched.groups):
        assert (g.L_off, g.U_off, g.Li_off, g.Ui_off) == (
            jg.L_off, jg.U_off, jg.Li_off, jg.Ui_off)
    assert lu.tiny_pivots == int(jlu.tiny_pivots)
    for what, a, b in zip(("L", "U", "Li", "Ui"), lu.flats(), ref):
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        assert rel_maxnorm(a.numpy(), b) < TOL[np.dtype(dtype)], what


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_arms_agree_bitwise_on_cpu(name, monkeypatch):
    """The staged and whole-phase arms run the same member bodies in the
    same order: equal slabs and solutions, bit for bit."""
    from superlu_dist_tpu_torch.ops import batched as tb
    _, lu_s, _ = _port_lu(name, np.float64, True, monkeypatch)
    _, lu_p, _ = _port_lu(name, np.float64, False, monkeypatch)
    for a, b in zip(lu_s.flats(), lu_p.flats()):
        assert np.array_equal(a.numpy(), b.numpy())
    b = np.random.default_rng(3).standard_normal((lu_s.plan.n, 3))
    for solve in (tb.solve_device, tb.solve_device_trans):
        assert np.array_equal(solve(lu_s, b), solve(lu_p, b))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name,dtype", [("lap3d6", np.float64),
                                        ("convdiff12", np.float64),
                                        ("randunsym200", np.float64),
                                        ("lap3d6", np.float32)])
def test_arm_solutions_match_reference(name, dtype, staged, trans,
                                       monkeypatch):
    """The port's own factors through its staged segment sweeps
    (StagedLU) or its packed solve (DeviceLU), against the reference's
    solve of its factors, at nrhs 1 and 8."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    pt, lu, jlu = _port_lu(name, dtype, staged, monkeypatch)
    rng = np.random.default_rng(17)
    jsolve = jb.solve_device_trans if trans else jb.solve_device
    tsolve = tb.solve_device_trans if trans else tb.solve_device
    for nrhs in (1, 8):
        b = rng.standard_normal((pt.n, nrhs)).astype(dtype)
        if nrhs == 1:
            b = b[:, 0]
        ref = jsolve(jlu, b)
        got = tsolve(lu, b)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert rel_maxnorm(got, ref) < TOL[np.dtype(dtype)], nrhs


def test_packed_panels_are_the_staged_views(monkeypatch):
    """pack_panels over a DeviceLU's slabs slices exactly the views
    pack_panels_staged takes from its per-group panels."""
    from superlu_dist_tpu_torch.ops import trisolve as tt
    _, lu, _ = _port_lu("convdiff12", np.float64, False, monkeypatch)
    ts = tt.get_trisolve(lu.schedule)
    for pa, pb in zip(tt.pack_panels(ts, lu.flats()),
                      tt.pack_panels_staged(ts, lu.panels)):
        for a, b in zip(pa, pb):
            assert a.shape == b.shape and a.stride() == b.stride()
            assert a.data_ptr() == b.data_ptr()
    assert tt.get_packs(lu) is tt.get_packs(lu)          # cached


def _handles(name, staged, monkeypatch):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_STAGED", "1" if staged else "0")
    aj, at = matrix_pair(name)
    return jslu.factorize(aj), st.factorize(at, device="cpu")


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_get_diag_u_and_query_space_match_reference(name, staged,
                                                    monkeypatch):
    import superlu_dist_tpu as jslu
    import superlu_dist_tpu_torch as st
    import importlib
    jg = importlib.import_module("superlu_dist_tpu.models.gssvx")
    tg = importlib.import_module("superlu_dist_tpu_torch.models.gssvx")
    jlu, tlu = _handles(name, staged, monkeypatch)
    ref = jslu.get_diag_u(jlu)
    got = st.get_diag_u(tlu)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert rel_maxnorm(got, ref) < 1e-12
    assert np.all(got != 0)
    assert st.query_space(tlu) == jslu.query_space(jlu)
    assert tg.factors_finite(tlu) and jg.factors_finite(jlu)
    got_arrays = tg.factor_arrays(tlu)
    assert sum(a.nbytes for a in got_arrays) == \
        st.query_space(tlu)["held_bytes"]
    assert tg.solve_rhs_dtype(tlu) == jg.solve_rhs_dtype(jlu)


def test_factors_finite_sees_a_poisoned_panel(monkeypatch):
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.models import gssvx as tg
    _, tlu = _handles("lap3d6", True, monkeypatch)
    assert tg.factors_finite(tlu)
    tlu.device_lu.panels[-1][2][0] = float("nan")
    assert not tg.factors_finite(tlu)
    assert st.query_space(tlu)["held_bytes"] == \
        tlu.device_lu.held_bytes()


@pytest.mark.parametrize("staged", [False, True])
def test_warm_solve_then_solve_equals_cold(staged, monkeypatch):
    import superlu_dist_tpu_torch as st
    monkeypatch.setenv("SLU_STAGED", "1" if staged else "0")
    _, at = matrix_pair("convdiff12")
    b = np.random.default_rng(9).standard_normal((at.n, 4))
    cold = st.factorize(at, device="cpu")
    warm = st.factorize(at, device="cpu")
    st.warm_solve(warm, nrhs_widths=(1, 4))
    np.testing.assert_array_equal(st.solve(warm, b), st.solve(cold, b))


def test_staged_signatures_and_cpu_warmup(monkeypatch):
    """One factor graph per merged segment, one solve graph pair per
    solve segment; on the CPU the warmup captures nothing."""
    import warnings
    from superlu_dist_tpu_torch.ops import batched as tb
    from superlu_dist_tpu_torch.ops import trisolve as tt
    from superlu_dist_tpu_torch.utils.warmup import (staged_signatures,
                                                     warmup_staged)
    js, ts = _schedules("lap3d6")
    fsigs, ssigs = staged_signatures(ts, "float64")
    assert sorted(fsigs.values()) == list(range(
        len(tb.get_factor_segments(ts))))
    assert sorted(ssigs.values()) == list(range(
        len(tt.get_trisolve(ts).segments)))
    import superlu_dist_tpu_torch as st
    _, at = matrix_pair("lap3d6")
    plan = st.plan_factorization(at, device="cpu")
    monkeypatch.setenv("SLU_STAGED", "0")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rep = warmup_staged(plan)
    assert rep["staged_inactive"] and w
    monkeypatch.setenv("SLU_STAGED", "1")
    rep = warmup_staged(plan)
    assert rep["captured"] == 0
    assert rep["factor_programs"] == len(tb.get_factor_segments(
        tb.get_schedule(plan)))
