"""The port's CUDA kernels against their plain PyTorch versions, and
the main path through them, on the card.

Marked `cuda`: without a CUDA card (or without nvcc to build the
kernels) every test here skips with its reason.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: the repository's conftest configures jax, which the
port's machine need not have.)
"""

import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The CUDA device, or a skip with the reason (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    if not (shutil.which("nvcc")
            or __import__("os").path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("no nvcc: the kernels are built on the card's host")
    return torch.device("cuda", torch.cuda.current_device())


TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _rel(a, b):
    """max|a − b| / max|b|, in float64 (0 when both vanish)."""
    d = float((a - b).abs().max())
    s = float(b.abs().max())
    return d / s if s else d


# K1's regimes and their edges: warp-per-front small fronts (the k=48
# schedule's most frequent bucket, and a batch that leaves warps idle),
# a small front with wb == mb, a small front with odd mb (scalar loads),
# CTA-per-front small fronts, the large regime with mb no tile multiple,
# with a partial last panel block and odd mb, at a middle shape of the
# k=48 schedule, and with wb == mb (a panel with no update)
_K1_SHAPES = [(4096, 16, 8), (5, 16, 8), (64, 128, 128), (3, 45, 24),
              (3, 96, 64), (1, 200, 128), (2, 363, 96), (2, 1536, 512),
              (1, 512, 512)]


def _k1_case(card, dtype, N, mb, wb, thresh):
    from superlu_dist_tpu_torch.ops import dense_lu, panel_lu
    g = torch.Generator(device=card).manual_seed(mb)
    F0 = torch.randn(N, mb, mb, generator=g, dtype=dtype, device=card)
    F0 += mb * torch.eye(mb, dtype=dtype, device=card)
    F0[0, 2, :] = 0
    F0[0, :, 2] = 0
    # one tiny pivot (replaced), or with thresh 0 an exact zero (counted)
    F0[0, 2, 2] = 1e-30 if thresh else 0.0
    F1, F2 = F0.clone(), F0.clone()
    _, t1, z1 = panel_lu.partial_lu_batch(F1, thresh, wb=wb)
    _, t2, z2 = dense_lu.partial_lu_batch(F2, thresh, wb=wb)
    torch.cuda.synchronize()
    return F0, F1, F2, (int(t1), int(z1)), (int(t2), int(z2))


@pytest.mark.parametrize("thresh", [1e-3, 0.0])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,mb,wb", _K1_SHAPES)
def test_panel_lu_kernel_matches_plain(card, dtype, N, mb, wb, thresh):
    """Counts equal exactly.  With thresh 0 the unreplaced zero pivot
    makes 0/0 below it, which the two versions spread differently (the
    plain version's Newton inverses fill whole blocks with NaN), so the
    values are compared where the plain version stays finite, and the
    kernel must be finite there too."""
    _, F1, F2, c1, c2 = _k1_case(card, dtype, N, mb, wb, thresh)
    assert c1 == c2 == ((1, 0) if thresh else (0, 1))
    if thresh:
        assert _rel(F1, F2) < TOL[dtype]
    else:
        ok = torch.isfinite(F2)
        assert torch.isfinite(F1[ok]).all()
        assert _rel(F1[ok], F2[ok]) < TOL[dtype]
        if N > 1:       # the other fronts hold no zero pivot at all
            assert _rel(F1[1:], F2[1:]) < TOL[dtype]


@pytest.mark.parametrize("N,mb,wb", [(5, 16, 8), (64, 128, 128),
                                     (3, 96, 64), (2, 363, 96)])
def test_panel_lu_kernel_in_cuda_graph(card, N, mb, wb):
    """K1 captured in a CUDA graph: a replay on fresh input equals an
    eager call, counters included (no host sync, no allocation in the
    launcher)."""
    from superlu_dist_tpu_torch.ops import panel_lu
    F0, F1, _, c1, _ = _k1_case(card, torch.float64, N, mb, wb, 1e-3)
    F = F0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, t, z = panel_lu.partial_lu_batch(F, 1e-3, wb=wb)
    F.copy_(F0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(F, F1)
    assert (int(t), int(z)) == c1


def _buckets(card, name):
    """Every element bucket of the named matrix's schedule, on the card,
    with its group."""
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.plan.plan import plan_factorization
    from superlu_dist_tpu_torch.utils import testmat
    fn, arg = name
    plan = plan_factorization(getattr(testmat, fn)(arg))
    sched = batched.get_schedule(plan)
    return sched, [(g, b) for g in sched.groups for b in g.dev(card).ea]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", [("laplacian_3d", 12),
                                  ("convection_diffusion_2d", 40)])
def test_ea_scatter_kernel_matches_plain(card, dtype, name):
    """Every bucket of the schedule, through both variants (one warp
    per front up to 32-wide children, banded CTAs above)."""
    from superlu_dist_tpu_torch.ops import ea_scatter
    sched, buckets = _buckets(card, name)
    g0 = torch.Generator(device=card).manual_seed(7)
    upd = torch.randn(sched.upd_total + sched.upd_pad, dtype=dtype,
                      device=card, generator=g0)
    wide = set()
    for grp, b in buckets:
        F0 = torch.randn(grp.n_loc, grp.mb, grp.mb, dtype=dtype,
                         device=card, generator=g0)
        F1, F2 = F0.clone(), F0.clone()
        ea_scatter.ea_scatter_add(F1, upd, b)
        ea_scatter.ea_scatter_add_plain(F2, upd, b)
        assert _rel(F1, F2) < TOL[dtype], (grp.mb, b.rc_b)
        wide.add(b.rc_b > 32)
    assert wide == {False, True}


@pytest.mark.parametrize("wide", [False, True])
def test_ea_scatter_trailing_sentinel_records(card, wide):
    """A bucket whose last records are all sentinel (their slab offsets
    run past the slab) adds exactly what the same bucket without them
    adds."""
    import dataclasses
    from superlu_dist_tpu_torch.ops import ea_scatter
    _, buckets = _buckets(card, ("laplacian_3d", 12))
    grp, b = max((gb for gb in buckets if (gb[1].rc_b > 32) == wide),
                 key=lambda gb: gb[1].so.numel())
    upd = torch.randn(int(b.so.max()) + b.rc_b * int(b.st.max()) + 1,
                      dtype=torch.float64, device=card)
    npad = 3
    pad = dataclasses.replace(
        b,
        so=torch.cat([b.so, b.so.new_full((npad,), upd.numel() + 10**6)]),
        st=torch.cat([b.st, b.st[-1:].repeat(npad)]),
        db=torch.cat([b.db, b.db[-1:].repeat(npad)]),
        pr=torch.cat([b.pr, b.pr.new_full((npad, b.rc_b), grp.mb)]),
        seg=torch.cat([b.seg[:-1], b.seg[-1:] + npad]))
    F0 = torch.randn(grp.n_loc, grp.mb, grp.mb, dtype=torch.float64,
                     device=card)
    F1, F2 = F0.clone(), F0.clone()
    ea_scatter.ea_scatter_add(F1, upd, pad)
    ea_scatter.ea_scatter_add(F2, upd, b)
    torch.cuda.synchronize()
    assert torch.equal(F1, F2)


def _lsum_case(card, pd, xd, R, t, wb, mb, rtrim):
    from superlu_dist_tpu_torch.ops import lsum
    g = torch.Generator(device=card).manual_seed(t * 1000 + wb + R)
    Lp = torch.randn(t, mb, wb, dtype=pd, device=card, generator=g) / wb
    Li = torch.randn(t, wb, wb, dtype=pd, device=card, generator=g) / wb
    xb = torch.randn(t, wb, R, dtype=xd, device=card, generator=g)
    bufs = [(torch.zeros(5 + t * wb, R, dtype=xd, device=card),
             torch.zeros(9 + t * rtrim, R, dtype=xd, device=card))
            for _ in range(2)]
    # L21 is a strided view: the rows of Lp past the pivot block
    lsum.lsum_panel(Li, Lp[:, wb:], xb, *bufs[0], 4, 8, rtrim)
    lsum.lsum_panel_plain(Li, Lp[:, wb:], xb, *bufs[1], 4, 8, rtrim)
    torch.cuda.synchronize()
    tol = TOL[pd] if pd == xd else 1e-12
    assert _rel(bufs[0][0], bufs[1][0]) < tol
    assert _rel(bufs[0][1], bufs[1][1]) < tol
    # rows outside the group's blocks of Y and UPD stay untouched
    assert not bufs[0][0][:4].any() and not bufs[0][0][4 + t * wb:].any()
    assert not bufs[0][1][:8].any()
    assert not bufs[0][1][8 + t * rtrim:].any()


_PAIRS = [(torch.float64, torch.float64), (torch.float32, torch.float32),
          (torch.float32, torch.float64)]


@pytest.mark.parametrize("pd,xd", _PAIRS)
@pytest.mark.parametrize("R", [1, 2, 7, 8, 9, 33, 64])
@pytest.mark.parametrize("t,wb,mb,rtrim", [(7, 32, 160, 120),
                                           (1, 128, 128, 0),
                                           (3, 40, 141, 101),
                                           (300, 24, 90, 60),
                                           (280, 16, 16, 0)])
def test_lsum_kernel_matches_plain(card, pd, xd, R, t, wb, mb, rtrim):
    """Narrow panels over several fronts; a root front without update
    rows (y alone); a depth (40) that is no multiple of the tile depth,
    with a ragged last row tile and rtrim below the panel's row count;
    and enough narrow fronts for the fused single launch, with and
    without update rows."""
    _lsum_case(card, pd, xd, R, t, wb, mb, rtrim)


@pytest.mark.parametrize("pd,xd", _PAIRS)
@pytest.mark.parametrize("R", [1, 64, 70])
def test_lsum_kernel_large_front(card, pd, xd, R):
    """A wide front (wb 512) with many update rows; at R = 70 the
    right-hand sides take two column tiles."""
    _lsum_case(card, pd, xd, R, 2, 512, 1600, 1000)


@pytest.mark.parametrize("R", [1, 4, 16])
def test_lsum_kernel_unaligned_rows(card, R):
    """Panel rows of odd length (wb 7) are not 16-byte aligned, so the
    stages copy element by element."""
    _lsum_case(card, torch.float64, torch.float64, R, 5, 7, 30, 20)
    _lsum_case(card, torch.float32, torch.float32, R, 5, 7, 30, 23)


def test_gssvx_on_card_launches_every_kernel(card):
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import ea_scatter, lsum, panel_lu
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    a = laplacian_3d(14)
    xtrue = np.random.default_rng(0).standard_normal(a.n)
    wrappers = (panel_lu.partial_lu_batch, ea_scatter.ea_scatter_add,
                lsum.lsum_panel)
    for f in wrappers:
        f.launches = 0
    x, lu, stats = st.gssvx(st.Options(), a, a.to_scipy() @ xtrue)
    assert lu.device.type == "cuda"
    assert all(f.launches > 0 for f in wrappers)
    assert stats.berr <= 64 * np.finfo(np.float64).eps
    assert np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue) < 1e-12


# --------------------------------------------------------------------
# the compiled-program layer: factor and solve programs as CUDA graphs
# (ops/graphs.py), held against the same bodies run eagerly
# --------------------------------------------------------------------

def _k2_graph_case(card, grp, b, upd, F0):
    from superlu_dist_tpu_torch.ops import ea_scatter
    F1, F2 = F0.clone(), F0.clone()
    ea_scatter.ea_scatter_add(F1, upd, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ea_scatter.ea_scatter_add(F2, upd, b)
    F2.copy_(F0)
    graph.replay()
    torch.cuda.synchronize()
    return F1, F2


@pytest.mark.parametrize("name", [("laplacian_3d", 12),
                                  ("convection_diffusion_2d", 40)])
def test_ea_scatter_kernel_in_cuda_graph(card, name):
    """K2 captured in a CUDA graph, narrow (per-destination lists) and
    wide (banded) buckets: a replay on fresh fronts equals an eager
    call bit for bit."""
    sched, buckets = _buckets(card, name)
    g0 = torch.Generator(device=card).manual_seed(5)
    upd = torch.randn(sched.upd_total + sched.upd_pad,
                      dtype=torch.float64, device=card, generator=g0)
    wide = set()
    for grp, b in buckets:
        F0 = torch.randn(grp.n_loc, grp.mb, grp.mb, dtype=torch.float64,
                         device=card, generator=g0)
        F1, F2 = _k2_graph_case(card, grp, b, upd, F0)
        assert torch.equal(F1, F2), (grp.mb, b.rc_b)
        wide.add(b.rc_b > 32)
    assert wide == {False, True}


@pytest.mark.parametrize("R", [1, 64])
@pytest.mark.parametrize("t,wb,mb,rtrim", [(2, 512, 1600, 1000),
                                           (300, 24, 90, 60),
                                           (7, 32, 160, 120)])
def test_lsum_kernel_in_cuda_graph(card, t, wb, mb, rtrim, R):
    """K3 captured in a CUDA graph: the wide fronts' cluster depth split
    (t 2, wb 512), the fused narrow launch and the tile products; a
    replay on a fresh right-hand side equals an eager call bit for
    bit."""
    from superlu_dist_tpu_torch.ops import lsum
    g = torch.Generator(device=card).manual_seed(t + wb + R)
    Lp = torch.randn(t, mb, wb, dtype=torch.float64, device=card,
                     generator=g) / wb
    Li = torch.randn(t, wb, wb, dtype=torch.float64, device=card,
                     generator=g) / wb
    x0 = torch.randn(t, wb, R, dtype=torch.float64, device=card,
                     generator=g)
    bufs = [(torch.zeros(5 + t * wb, R, dtype=torch.float64, device=card),
             torch.zeros(9 + t * rtrim, R, dtype=torch.float64,
                         device=card)) for _ in range(2)]
    xb = torch.zeros_like(x0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lsum.lsum_panel(Li, Lp[:, wb:], xb, *bufs[1], 4, 8, rtrim)
    xb.copy_(x0)
    graph.replay()
    lsum.lsum_panel(Li, Lp[:, wb:], x0, *bufs[0], 4, 8, rtrim)
    torch.cuda.synchronize()
    assert torch.equal(bufs[0][0], bufs[1][0])
    assert torch.equal(bufs[0][1], bufs[1][1])


def _plan(card, k=12):
    """A laplacian_3d(k) plan on the card and its scaled values."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    a = laplacian_3d(k)
    plan = st.plan_factorization(a, device=card)
    return a, plan, plan.scaled_values(a)


def _arm(monkeypatch, staged):
    monkeypatch.setenv("SLU_STAGED", "1" if staged else "0")


def _flats_equal(x, y):
    return all(torch.equal(a, b) for a, b in zip(x.flats(), y.flats()))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("staged", [True, False])
def test_graph_factor_and_solve_equal_eager(card, monkeypatch, staged,
                                            dtype):
    """Both arms, both dtypes: the first factorization captures, the
    second only replays, and both give the eager loop's slabs, tiny
    counts and solutions (NOTRANS and TRANS, nrhs 1 and 5) bit for
    bit."""
    from superlu_dist_tpu_torch.ops import batched, graphs
    _arm(monkeypatch, staged)
    _, plan, vals = _plan(card)
    sched = batched.get_schedule(plan)
    ref = batched.factorize_device(plan, vals, dtype, card, eager=True)
    lu1 = batched.factorize_device(plan, vals, dtype, card)
    n_graphs = graphs.graph_count(sched)
    nseg = (len(batched.get_factor_segments(sched)) if staged else 1)
    assert n_graphs == nseg
    lu2 = batched.factorize_device(plan, vals, dtype, card)
    assert graphs.graph_count(sched) == n_graphs       # replay only
    assert isinstance(lu1, batched.StagedLU if staged
                      else batched.DeviceLU)
    assert _flats_equal(lu1, ref) and _flats_equal(lu2, ref)
    assert lu1.tiny_pivots == lu2.tiny_pivots == ref.tiny_pivots
    rng = np.random.default_rng(1)
    for R in (1, 5):
        b = rng.standard_normal((plan.n, R))
        for solve in (batched.solve_device, batched.solve_device_trans):
            x_ref = solve(ref, b, eager=True)
            assert np.array_equal(solve(lu1, b), x_ref)
            assert np.array_equal(solve(lu1, b), x_ref)     # replay
            assert np.array_equal(solve(lu2, b), x_ref)


@pytest.mark.parametrize("staged", [True, False])
def test_held_factorization_is_never_overwritten(card, monkeypatch,
                                                 staged):
    """Factor A1, then A2 on the same plan (new values, the
    SAME_PATTERN_SAME_ROWPERM rung), then solve with the first handle:
    it still holds A1's factors and gives A1's solution."""
    from superlu_dist_tpu_torch.ops import batched
    _arm(monkeypatch, staged)
    _, plan, v1 = _plan(card)
    v2 = v1 * (1.0 + 0.5 * np.random.default_rng(2).random(len(v1)))
    lu1 = batched.factorize_device(plan, v1, np.float64, card)
    snap = [f.clone() for f in lu1.flats()]
    b = np.random.default_rng(3).standard_normal((plan.n, 2))
    x1 = batched.solve_device(lu1, b)
    lu2 = batched.factorize_device(plan, v2, np.float64, card)
    x2 = batched.solve_device(lu2, b)
    assert all(torch.equal(a, s) for a, s in zip(lu1.flats(), snap))
    assert np.array_equal(batched.solve_device(lu1, b), x1)
    ref1 = batched.factorize_device(plan, v1, np.float64, card,
                                    eager=True)
    assert np.array_equal(x1, batched.solve_device(ref1, b, eager=True))
    assert not np.allclose(x1, x2)


@pytest.mark.parametrize("staged", [True, False])
def test_one_capture_serves_two_thresholds(card, monkeypatch, staged):
    """K1 reads the GESP threshold on the device: one capture serves a
    second value set whose threshold differs (‖A‖ 1e9 times larger, so
    that pivots get replaced), with tiny counts and slabs equal to the
    eager loop's at each threshold."""
    from superlu_dist_tpu_torch.ops import batched, graphs
    _arm(monkeypatch, staged)
    _, plan, vals = _plan(card)
    sched = batched.get_schedule(plan)
    counts = []
    for anorm in (plan.anorm, plan.anorm * 1e9):
        plan.anorm = anorm
        lu = batched.factorize_device(plan, vals, np.float64, card)
        ref = batched.factorize_device(plan, vals, np.float64, card,
                                       eager=True)
        assert lu.tiny_pivots == ref.tiny_pivots
        assert _flats_equal(lu, ref)
        counts.append(lu.tiny_pivots)
    assert counts[0] == 0 < counts[1]
    assert graphs.graph_count(sched) == (
        len(batched.get_factor_segments(sched)) if staged else 1)


@pytest.mark.parametrize("staged", [True, False])
def test_zero_pivot_raises_after_replay(card, monkeypatch, staged):
    """replace_tiny_pivot=NO with an exactly singular leading block
    raises ZeroDivisionError on the capturing run and on a replay."""
    import scipy.sparse as sp
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched, graphs
    from superlu_dist_tpu_torch.options import RowPerm, YesNo
    _arm(monkeypatch, staged)
    A = st.csr_from_scipy(sp.csr_matrix(np.array([[1.0, 1.0, 0.0],
                                                  [1.0, 1.0, 0.0],
                                                  [0.0, 0.0, 1.0]])))
    opts = st.Options(replace_tiny_pivot=YesNo.NO, equil=YesNo.NO,
                      row_perm=RowPerm.NOROWPERM)
    plan = st.plan_factorization(A, opts, device=card)
    vals = plan.scaled_values(A)
    for _ in range(2):
        with pytest.raises(ZeroDivisionError):
            batched.factorize_device(plan, vals, np.float64, card)
    assert graphs.graph_count(batched.get_schedule(plan)) >= 1


@pytest.mark.parametrize("staged", [True, False])
def test_launch_counters_count_replays(card, monkeypatch, staged):
    """A capture records launches without counting them; every replay
    adds them: a capturing run, a replaying run and the eager loop count
    the same launches, factor and solve."""
    from superlu_dist_tpu_torch.ops import batched, graphs
    _arm(monkeypatch, staged)
    _, plan, vals = _plan(card)
    b = np.random.default_rng(4).standard_normal(plan.n)
    seen = []
    for eager in (False, False, True):
        for f in graphs.COUNTED:
            f.launches = 0
        lu = batched.factorize_device(plan, vals, np.float64, card,
                                      eager=eager)
        batched.solve_device(lu, b, eager=eager)
        seen.append(tuple(f.launches for f in graphs.COUNTED))
    assert seen[0] == seen[1] == seen[2]
    assert all(c > 0 for c in seen[0])


def test_warmup_captures_every_segment_ahead(card, monkeypatch):
    """warmup_staged captures each factor segment graph before any
    values exist; gssvx then only replays, through every kernel, and a
    SAME_PATTERN_SAME_ROWPERM refactorization captures nothing new."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched, graphs
    from superlu_dist_tpu_torch.utils.warmup import warmup_staged
    _arm(monkeypatch, True)
    a, plan, _ = _plan(card)
    rep = warmup_staged(plan, "float64")
    sched = batched.get_schedule(plan)
    assert rep["captured"] == rep["factor_programs"] == len(
        batched.get_factor_segments(sched))
    n0 = graphs.graph_count(sched)
    xtrue = np.random.default_rng(0).standard_normal(a.n)
    b = a.to_scipy() @ xtrue
    lu = st.factorize(a, plan=plan)
    assert graphs.graph_count(sched) == n0
    st.warm_solve(lu, (1,))
    x, lu2, stats = st.gssvx(
        st.Options(fact=st.Fact.SAME_PATTERN_SAME_ROWPERM), a, b, lu=lu)
    assert graphs.graph_count(sched) == n0
    assert stats.berr <= 64 * np.finfo(np.float64).eps
    assert np.linalg.norm(x - xtrue) / np.linalg.norm(xtrue) < 1e-12
    assert np.array_equal(st.get_diag_u(lu2), st.get_diag_u(lu))


def test_capture_survives_garbage_holding_a_graph(card):
    """A graph held only by a reference cycle (as a fused context holds
    its graphs) is garbage until a collection frees it; a collection
    inside a later capture would destroy it while the stream captures.
    Captures run with collection off: a body that lowers the threshold
    to 1 and then allocates many objects still captures and replays."""
    import gc
    from superlu_dist_tpu_torch.ops import graphs
    x = torch.ones(4, dtype=torch.float64, device=card)
    old = gc.get_threshold()
    gc.collect()

    def body():
        gc.set_threshold(1)
        for i in range(200):
            x.add_(0.0)
            [i]                         # one container allocation

    try:
        held = graphs.GraphSet(card)
        held.run("a", lambda: x.mul_(1.0))
        cycle = [held]
        cycle.append(cycle)
        del held, cycle
        graphs.GraphSet(card).run("b", body)
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones_like(x))
    gc.collect()


def test_failed_capture_raises(card):
    """A body that syncs with the host cannot be captured: the capture
    raises, with no eager fallback, and keeps no graph."""
    from superlu_dist_tpu_torch.ops import graphs
    gset = graphs.GraphSet(card)
    x = torch.ones(4, dtype=torch.float64, device=card)
    with pytest.raises(RuntimeError):
        gset.run("sync", lambda: float(x.sum()))
    assert not gset.graphs


# --------------------------------------------------------------------
# refinement on the device: the residual SpMV (ops/spmv.py) and the
# fused solver (ops/batched.py make_fused_solver), graphs against the
# same bodies run eagerly
# --------------------------------------------------------------------

def _ragged(k=12):
    """laplacian_3d(k) with row 7 emptied: ragged rows and one empty
    row, so the ELL band has pad slots everywhere."""
    import scipy.sparse as sp
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    m = laplacian_3d(k).to_scipy().tolil()
    m[7, :] = 0
    m = sp.csr_matrix(m)
    m.eliminate_zeros()
    return st.csr_from_scipy(m)


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_device_spmv_on_card_matches_scipy(card, monkeypatch, layout):
    """Both layouts against scipy at nrhs 1 (1-D) and 3, with pad slots
    in every ELL row (none may index past x); the ELL lane gives the
    same bits on every call, the COO lane's atomic adds agree with the
    ELL lane to rounding."""
    from superlu_dist_tpu_torch.ops.spmv import DeviceSpMV
    a = _ragged()
    sp = a.to_scipy()
    monkeypatch.setenv("SLU_SPMV_LAYOUT", layout)
    m = DeviceSpMV.build(a, device=card)
    monkeypatch.setenv("SLU_SPMV_LAYOUT", "ell")
    ell = DeviceSpMV.build(a, device=card)
    assert m.layout == layout
    rng = np.random.default_rng(8)
    for x in (rng.standard_normal(a.n), rng.standard_normal((a.n, 3))):
        xt = torch.from_numpy(x).to(card)
        y = m.matvec(xt)
        ya = m.absmatvec(xt.abs())
        torch.cuda.synchronize()
        np.testing.assert_allclose(y.cpu().numpy(), sp @ x, rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(ya.cpu().numpy(), abs(sp) @ np.abs(x),
                                   rtol=1e-12)
        assert _rel(y, ell.matvec(xt)) <= 1e-15
        if layout == "ell":
            assert all(torch.equal(m.matvec(xt), y) for _ in range(3))


def _fused_plan(card, k=10):
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    a = laplacian_3d(k)
    return a, st.plan_factorization(a, device=card)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("staged", [True, False])
def test_fused_solver_graphs_equal_eager(card, monkeypatch, staged,
                                         dtype):
    """Both arms, f64 and f32 factors (f64 refinement), nrhs 1 and 4:
    the graph replays give the eager loop's x and berr bit for bit, the
    same steps and counts, berr ≤ 64·eps(f64); every kernel launched;
    the second and third calls capture no graph."""
    from superlu_dist_tpu_torch.ops import batched, graphs
    _arm(monkeypatch, staged)
    a, plan = _fused_plan(card)
    vals = torch.from_numpy(a.data).to(card)
    eager = batched.make_fused_solver(plan, dtype, eager=True)
    step = batched.make_fused_solver(plan, dtype)
    assert step.context is not eager.context
    assert step.context.staged == staged
    rng = np.random.default_rng(9)
    for R in (1, 4):
        b = torch.from_numpy(rng.standard_normal((a.n, R))).to(card)
        ref = eager(vals, b)
        counts = []
        for f in graphs.COUNTED:
            f.launches = 0
        for call in range(3):
            out = step(vals, b)
            counts.append(step.context.graph_count())
            assert torch.equal(out[0], ref[0])
            assert torch.equal(out[1], ref[1])
            assert [int(o) for o in out[2:]] == [int(o) for o in ref[2:]]
        assert counts[0] == counts[1] == counts[2] > 0
        assert all(f.launches > 0 for f in graphs.COUNTED)
        assert float(out[1]) <= 64 * np.finfo(np.float64).eps
        assert out[0].dtype == torch.float64 and out[0].device == card
        if dtype == "float32":
            assert int(out[2]) >= 1


def test_fused_step_graphs_equal_eager(card):
    from superlu_dist_tpu_torch.ops import batched
    a, plan = _fused_plan(card)
    vals = plan.scaled_values(a)
    b = np.random.default_rng(10).standard_normal((a.n, 2))
    x = batched.make_fused_step(plan, np.float64)(vals, b)
    x_ref = batched.make_fused_step(plan, np.float64, eager=True)(vals, b)
    assert torch.equal(x, x_ref)
    lu = batched.factorize_device(plan, vals, np.float64, card, eager=True)
    assert np.array_equal(x.cpu().numpy(),
                          batched.solve_device(lu, b, eager=True))


@pytest.mark.parametrize("staged", [True, False])
def test_fused_call_leaves_held_factorization(card, monkeypatch, staged):
    """A gssvx handle factored before fused calls on the same plan
    (which replay the same factor graphs) solves to the same bits after
    them, and its factors are unchanged."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    _arm(monkeypatch, staged)
    a, plan = _fused_plan(card)
    lu = st.factorize(a, plan=plan)
    snap = [f.clone() for f in lu.device_lu.flats()]
    b = np.random.default_rng(11).standard_normal(a.n)
    x0 = st.solve(lu, b)
    step = batched.make_fused_solver(plan, "float64")
    for scale in (2.0, 3.0):
        step(torch.from_numpy(a.data * scale).to(card), b[:, None])
    assert all(torch.equal(f, s) for f, s in
               zip(lu.device_lu.flats(), snap))
    assert np.array_equal(st.solve(lu, b), x0)


@pytest.mark.parametrize("staged", [True, False])
def test_fused_zero_pivot_returns_nzero(card, monkeypatch, staged):
    """replace_tiny_pivot=NO with an exactly singular leading block: the
    fused solver returns nzero > 0 and a non-finite berr on the capturing
    call and on a replay, and raises nothing."""
    import scipy.sparse as sp
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.options import RowPerm, YesNo
    _arm(monkeypatch, staged)
    A = st.csr_from_scipy(sp.csr_matrix(np.array([[1.0, 1.0, 0.0],
                                                  [1.0, 1.0, 0.0],
                                                  [0.0, 0.0, 1.0]])))
    opts = st.Options(replace_tiny_pivot=YesNo.NO, equil=YesNo.NO,
                      row_perm=RowPerm.NOROWPERM)
    plan = st.plan_factorization(A, opts, device=card)
    step = batched.make_fused_solver(plan, "float64")
    for _ in range(2):
        x, berr, steps, tiny, nzero = step(A.data, np.ones((3, 1)))
        assert int(nzero) > 0 and int(steps) == 0
        assert not bool(torch.isfinite(berr))


def test_factorize_uploads_the_schedule_once(card):
    """factorize(..., device="cuda") (no index) keeps one device copy
    of every group's index sets, under the indexed device's name."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    a = laplacian_3d(8)
    lu = st.factorize(a, device="cuda")
    st.solve(lu, np.ones(a.n))
    sched = batched.get_schedule(lu.plan)
    assert all(list(g._dev) == [str(card)] for g in sched.groups)
    assert lu.device == card
