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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,mb,wb", [(5, 16, 8), (3, 96, 64),
                                     (1, 200, 128)])
def test_panel_lu_kernel_matches_plain(card, dtype, N, mb, wb):
    from superlu_dist_tpu_torch.ops import dense_lu, panel_lu
    g = torch.Generator(device=card).manual_seed(mb)
    F0 = torch.randn(N, mb, mb, generator=g, dtype=dtype, device=card)
    F0 += mb * torch.eye(mb, dtype=dtype, device=card)
    F0[0, 2, :] = 0
    F0[0, :, 2] = 0
    F0[0, 2, 2] = 1e-30                     # one tiny pivot
    F1, F2 = F0.clone(), F0.clone()
    _, t1, z1 = panel_lu.partial_lu_batch(F1, 1e-3, wb=wb)
    _, t2, z2 = dense_lu.partial_lu_batch(F2, 1e-3, wb=wb)
    torch.cuda.synchronize()
    assert _rel(F1, F2) < TOL[dtype]
    assert (int(t1), int(z1)) == (int(t2), int(z2)) == (1, 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ea_scatter_kernel_matches_plain(card, dtype):
    from superlu_dist_tpu_torch.ops import batched, ea_scatter
    from superlu_dist_tpu_torch.plan.plan import plan_factorization
    from superlu_dist_tpu_torch.utils.testmat import laplacian_3d
    plan = plan_factorization(laplacian_3d(12))
    sched = batched.get_schedule(plan)
    upd = torch.randn(sched.upd_total + sched.upd_pad, dtype=dtype,
                      device=card)
    n = 0
    for grp in sched.groups:
        for b in grp.dev(card).ea:
            F0 = torch.randn(grp.n_loc, grp.mb, grp.mb, dtype=dtype,
                             device=card)
            F1, F2 = F0.clone(), F0.clone()
            ea_scatter.ea_scatter_add(F1, upd, b)
            ea_scatter.ea_scatter_add_plain(F2, upd, b)
            assert _rel(F1, F2) < TOL[dtype]
            n += 1
    assert n > 0


@pytest.mark.parametrize("pd,xd", [(torch.float64, torch.float64),
                                   (torch.float32, torch.float32),
                                   (torch.float32, torch.float64)])
@pytest.mark.parametrize("R", [1, 3, 64])
@pytest.mark.parametrize("t,wb,mb,rtrim", [(7, 32, 160, 120),
                                           (1, 128, 128, 0)])
def test_lsum_kernel_matches_plain(card, pd, xd, R, t, wb, mb, rtrim):
    """Narrow panels over several fronts, and a root front without
    update rows (y alone, split over one cluster)."""
    from superlu_dist_tpu_torch.ops import lsum
    Lp = torch.randn(t, mb, wb, dtype=pd, device=card) / wb
    Li = torch.randn(t, wb, wb, dtype=pd, device=card) / wb
    xb = torch.randn(t, wb, R, dtype=xd, device=card)
    bufs = [(torch.zeros(5 + t * wb, R, dtype=xd, device=card),
             torch.zeros(9 + t * rtrim, R, dtype=xd, device=card))
            for _ in range(2)]
    lsum.lsum_panel(Li, Lp[:, wb:], xb, *bufs[0], 4, 8, rtrim)
    lsum.lsum_panel_plain(Li, Lp[:, wb:], xb, *bufs[1], 4, 8, rtrim)
    torch.cuda.synchronize()
    tol = TOL[pd] if pd == xd else 1e-12
    assert _rel(bufs[0][0], bufs[1][0]) < tol
    assert _rel(bufs[0][1], bufs[1][1]) < tol


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
