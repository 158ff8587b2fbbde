"""K1's host-side launch plan (ops/panel_lu.launch_plan): the regime,
launch count, shared memory and grids the kernel uses for every group
shape, checked on the CPU against the card's limits."""

import pytest
import torch

from superlu_dist_tpu_torch.ops import panel_lu

_DTYPES = [torch.float64, torch.float32]


def _shapes(fn, arg):
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.plan.plan import plan_factorization
    from superlu_dist_tpu_torch.utils import testmat
    plan = plan_factorization(getattr(testmat, fn)(arg))
    sched = batched.build_schedule(plan)
    return sorted({(g.n_loc, g.mb, g.wb) for g in sched.groups})


def _within_limits(p):
    assert p.smem_bytes <= panel_lu.SMEM_LIMIT
    assert p.kernels == len(p.grids) >= 1
    for x, y, z in p.grids:
        assert 1 <= x <= 2**31 - 1
        assert 1 <= y <= panel_lu.GRID_YZ_MAX
        assert 1 <= z <= panel_lu.GRID_YZ_MAX


# the regimes each schedule reaches: laplacian_3d(12) has fronts up to
# mb 512 (wb == mb at its root); convection_diffusion_2d(40) stays small
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("name,reached", [
    (("laplacian_3d", 12), {"small", "large"}),
    (("convection_diffusion_2d", 40), {"small"})])
def test_launch_plan_fits_every_schedule_shape(name, reached, dtype):
    shapes = _shapes(*name)
    it = 8 if dtype == torch.float64 else 4
    regimes = set()
    for N, mb, wb in shapes:
        p = panel_lu.launch_plan(N, mb, wb, dtype)
        _within_limits(p)
        small = mb * mb * it <= panel_lu.SMALL_FRONT_BYTES
        assert p.regime == ("small" if small else "large"), (N, mb, wb)
        if small:
            assert p.kernels == 1
        regimes.add(p.regime)
    assert regimes == reached


# (N, mb, wb, dtype) -> (regime, kernels per call): shapes of the
# laplacian_3d(48) schedule (its root, a middle group, its most
# frequent bucket), the regime boundary in both dtypes, wb == mb in
# both regimes, and a batch past the 65535 grid limit
@pytest.mark.parametrize("N,mb,wb,dtype,regime,kernels", [
    (2, 6144, 512, torch.float64, "large", 9 + 3),
    (6, 2048, 512, torch.float64, "large", 9 + 3),
    (4096, 16, 8, torch.float64, "small", 1),
    (3072, 128, 32, torch.float64, "small", 1),
    (2, 256, 64, torch.float64, "large", 2 + 3),
    (1, 181, 64, torch.float32, "small", 1),
    (1, 182, 64, torch.float32, "large", 2 + 3),
    (64, 128, 128, torch.float64, "small", 1),
    (1, 512, 512, torch.float64, "large", 8 + 1),
    (70000, 256, 64, torch.float32, "large", 2 * (2 + 3)),
])
def test_launch_plan_regimes(N, mb, wb, dtype, regime, kernels):
    p = panel_lu.launch_plan(N, mb, wb, dtype)
    assert (p.regime, p.kernels) == (regime, kernels)
    _within_limits(p)
    if regime == "large" and mb > wb:
        # the last launch is the one depth-wb update over every output
        # tile of the last batch chunk
        bm, bn = panel_lu.UPDATE_TILE[:2]
        rb = mb - wb
        nf = N - (N - 1) // panel_lu.GRID_YZ_MAX * panel_lu.GRID_YZ_MAX
        assert p.grids[-1] == (-(-rb // bn), -(-rb // bm), nf)


def test_launch_plan_small_front_shared_memory():
    """The largest small front, 128 x 128 float64 with wb == mb, holds
    the whole front plus 16 bytes of padding per row in one CTA; warp
    mode puts eight fronts of at most 32 x 32 in one CTA, in registers;
    rows that are not 16-byte aligned pad by one element.  No
    workspace."""
    p = panel_lu.launch_plan(1, 128, 128, torch.float64)
    assert p.smem_bytes == (128 * 130 + 128 * 2) * 8
    q = panel_lu.launch_plan(4096, 16, 8, torch.float64)
    assert q.grids == ((512, 1, 1),)
    assert q.smem_bytes == 0
    r = panel_lu.launch_plan(3, 45, 24, torch.float32)
    assert r.smem_bytes == (45 * 25 + 24 * 22) * 4
    assert p.work_elems == q.work_elems == r.work_elems == 0


def test_launch_plan_large_workspace():
    """The large regime keeps, per front, inv(L11) and inv(U11) of every
    64-column panel block, and the panel's L (mb x wb) and U (wb x wb)
    until the panel phase ends."""
    p = panel_lu.launch_plan(2, 6144, 512, torch.float64)
    assert p.work_elems == 2 * (8 * 2 * 64 * 64 + 6144 * 512 + 512 * 512)
    assert panel_lu.launch_plan(1, 363, 96, torch.float64).work_elems \
        == 2 * 2 * 64 * 64 + 363 * 96 + 96 * 96


def test_launch_plan_rejects_bad_shapes():
    with pytest.raises(ValueError):
        panel_lu.launch_plan(1, 16, 17, torch.float64)
    with pytest.raises(ValueError):
        panel_lu.launch_plan(1, 16, 0, torch.float64)
    with pytest.raises(TypeError):
        panel_lu.launch_plan(1, 16, 8, torch.float16)


def test_k1_flops_matches_rank1_count():
    """k1_flops counts, per eliminated column, the divisions below the
    pivot and the rank-1 update of the trailing block."""
    mb, wb = 7, 3
    want = sum((mb - k - 1) + 2 * (mb - k - 1) ** 2 for k in range(wb))
    assert panel_lu.k1_flops(5, mb, wb) == 5 * want
    assert panel_lu.k1_bytes(5, mb, 8) == 2 * 5 * mb * mb * 8
