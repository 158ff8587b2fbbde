"""The three kernels' plain PyTorch versions against the JAX package:
the Pallas kernels in interpret mode (as the JAX package's own tests
run them on the CPU) and their plain references.

  K1 partial_lu_batch      vs pallas_lu.partial_lu_batch_pallas and
                              dense_lu.partial_lu_batch(pallas=False)
  K2 element extend-add    vs pallas_scatter.scatter_add_delta and the
                              `.at[].add` lane (batched._ea_add)
  K3 fused lsum pair       vs pallas_lsum.lsum_panel and its _oracle

On the CPU every wrapper takes its plain version (the tensors lie on
the CPU), so the wrappers are what these tests call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import TOL, rel_maxnorm


def _mosaic_bug(e: Exception) -> bool:
    """This environment's interpret-mode lowering bug
    (tests/test_trisolve.py documents it): compare with the plain
    reference alone when it fires."""
    msg = str(e)
    return "func.call" in msg and "operand type mismatch" in msg


# ---------------------------------------------------------------- K1

def _fronts(n, mb, dtype, seed, tiny_at=None):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, mb, mb)).astype(dtype)
    F += mb * np.broadcast_to(np.eye(mb, dtype=dtype), F.shape)
    if tiny_at is not None:
        # decouple row/col t of front 0: its pivot is exactly tiny and
        # its replacement causes no growth elsewhere
        t = tiny_at
        F[0, t, :] = 0
        F[0, :, t] = 0
        F[0, t, t] = dtype(1e-12)
    return F


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("thresh", [0.0, 1e-6])
@pytest.mark.parametrize("mb,wb,n", [(16, 8, 3), (64, 32, 2),
                                     (96, 64, 2), (64, 64, 1)])
def test_panel_lu_plain_matches_reference(dtype, thresh, mb, wb, n):
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu.ops import pallas_lu
    from superlu_dist_tpu_torch.ops.panel_lu import partial_lu_batch
    F = _fronts(n, mb, dtype, seed=mb + wb, tiny_at=3 if thresh else None)
    got, t, z = partial_lu_batch(torch.from_numpy(F.copy()), thresh,
                                 wb=wb)
    ref, tr, zr = jd.partial_lu_batch(jnp.asarray(F),
                                      jnp.asarray(thresh, dtype), wb=wb,
                                      pallas=False)
    tol = TOL[np.dtype(dtype)]
    assert rel_maxnorm(got.numpy(), np.asarray(ref)) < tol
    assert (int(t), int(z)) == (int(tr), int(zr))
    assert int(t) == (1 if thresh else 0)
    if dtype == np.float32:       # the Pallas kernel is f32-only
        try:
            pk, tp, zp = pallas_lu.partial_lu_batch_pallas(
                jnp.asarray(F), jnp.float32(thresh), wb=wb,
                interpret=True)
        except Exception as e:    # noqa: BLE001 — see _mosaic_bug
            if not _mosaic_bug(e):
                raise
        else:
            assert rel_maxnorm(got.numpy(), np.asarray(pk)) < tol
            assert (int(t), int(z)) == (int(tp), int(zp))


def test_panel_lu_zero_pivot_counted():
    """thresh == 0 (ReplaceTinyPivot=NO): an exact zero pivot is
    counted, not replaced, like the reference."""
    from superlu_dist_tpu.ops import dense_lu as jd
    from superlu_dist_tpu_torch.ops.panel_lu import partial_lu_batch
    F = np.broadcast_to(np.eye(16), (2, 16, 16)).copy()
    F[1, 5, 5] = 0.0
    _, t, z = partial_lu_batch(torch.from_numpy(F.copy()), 0.0, wb=8)
    _, tr, zr = jd.partial_lu_batch(jnp.asarray(F), jnp.asarray(0.0),
                                    wb=8, pallas=False)
    assert (int(t), int(z)) == (int(tr), int(zr)) == (0, 1)


# ---------------------------------------------------------------- K2

def _bucket_data(dtype, seed=0):
    """One element bucket with row/col sentinels and K-padding
    records (positions all sentinel, front base repeating the last
    real one), over 3 fronts of size mb."""
    rng = np.random.default_rng(seed)
    n_pad, mb, rc_b = 3, 16, 6
    nreal, K = 5, 8
    slab = rng.standard_normal(400).astype(dtype)
    so = np.zeros(K, np.int64)
    st = np.zeros(K, np.int64)
    db = np.zeros(K, np.int64)
    pr = np.full((K, rc_b), mb, np.int64)
    fronts = [0, 0, 1, 2, 2]
    for k in range(nreal):
        rc = rc_b - (k % 2)               # some rows are sentinels
        so[k] = 40 * k
        st[k] = rc + 1
        db[k] = fronts[k] * mb * mb
        pr[k, :rc] = np.sort(rng.choice(mb, rc, replace=False))
    db[nreal:] = db[nreal - 1]
    so[nreal:] = 390                      # padding lanes run past the slab
    st[nreal:] = 7
    return n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr


def _port_bucket(so, st, db, pr, mb, nreal):
    from superlu_dist_tpu_torch.ops.batched import GroupSpec
    g = GroupSpec(level=0, mb=mb, wb=mb, n_loc=3, n_true=3,
                  sup_ids=np.arange(3), sup_pos=np.arange(3),
                  a_src=np.zeros(1, np.int64),
                  a_dst=np.full(1, 3 * mb * mb, np.int64),
                  one_dst=np.full(1, 3 * mb * mb, np.int64),
                  ea_hosts=((so, st, db, pr),),
                  ea_meta=((pr.shape[1], len(so), nreal),),
                  col_idx=np.zeros((3, mb), np.int64),
                  struct_idx=np.zeros((3, 0), np.int64),
                  upd_off_global=0, L_off=0, U_off=0, Li_off=0, Ui_off=0)
    (b,) = g.dev(torch.device("cpu")).ea
    return b


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ea_scatter_plain_matches_reference(dtype):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu.ops import pallas_scatter
    from superlu_dist_tpu_torch.ops.ea_scatter import ea_scatter_add
    n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr = _bucket_data(dtype)
    F0 = np.random.default_rng(1).standard_normal(
        (n_pad, mb, mb)).astype(dtype)
    b = _port_bucket(so, st, db, pr, mb, nreal)
    assert b.so.numel() == nreal            # K-padding dropped
    Ft = torch.from_numpy(F0.copy())
    ea_scatter_add(Ft, torch.from_numpy(slab), b)

    # the reference's element lane (.at[].add with mode="drop")
    blocks = ((jnp.asarray(so), jnp.asarray(st), jnp.asarray(db),
               jnp.asarray(pr), jnp.asarray(pr)),)
    ref = jb._ea_add(jnp.asarray(F0.reshape(-1)), jnp.asarray(slab),
                     blocks, ((rc_b, rc_b, K, K),), mb=mb, n_pad=n_pad,
                     allow_pallas=False)
    tol = TOL[np.dtype(dtype)]
    assert rel_maxnorm(Ft.numpy().reshape(-1), np.asarray(ref)) < tol

    if dtype == np.float32:     # the Pallas scatter engine is f32-only
        ai = np.arange(rc_b)
        src = np.minimum(so[:, None, None] + ai[None, :, None]
                         * st[:, None, None] + ai[None, None, :],
                         len(slab) - 1)
        try:
            delta = pallas_scatter.scatter_add_delta(
                jnp.asarray(slab[src]), jnp.asarray(pr, jnp.int32),
                jnp.asarray(pr, jnp.int32),
                jnp.asarray(db // (mb * mb), jnp.int32),
                mb=mb, ncols=mb, n_pad=n_pad, interpret=True)
        except Exception as e:  # noqa: BLE001 — see _mosaic_bug
            if not _mosaic_bug(e):
                raise
        else:
            assert rel_maxnorm(Ft.numpy(), F0 + np.asarray(delta)) < tol


def test_ea_scatter_padding_changes_nothing():
    """A bucket whose records are all K-padding (all-sentinel lanes)
    leaves the fronts bit-for-bit unchanged, and the live lanes never
    index past the slab."""
    from superlu_dist_tpu_torch.ops.ea_scatter import (
        ea_scatter_add_plain, flat_indices)
    n_pad, mb, rc_b, K, nreal, slab, so, st, db, pr = _bucket_data(
        np.float64)
    b = _port_bucket(so, st, db, pr, mb, nreal)
    F = torch.zeros(n_pad, mb, mb, dtype=torch.float64)
    dst, src = flat_indices(F, b)
    assert int(src.max()) < len(slab) and int(dst.max()) < F.numel()
    pad_pr = torch.full((2, rc_b), mb, dtype=torch.int64)
    b.pr, b.so, b.st, b.db = (pad_pr, b.so[:2] + 10_000, b.st[:2],
                              b.db[:2])
    b.fronts, b.seg = b.fronts[:1], torch.tensor([0, 2])
    F0 = torch.randn(n_pad, mb, mb, dtype=torch.float64)
    F1 = F0.clone()
    ea_scatter_add_plain(F1, torch.from_numpy(slab), b)
    assert torch.equal(F0, F1)


# ---------------------------------------------------------------- K3

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R", [1, 8, 64])
def test_lsum_plain_matches_reference(dtype, R):
    from superlu_dist_tpu.ops import pallas_lsum
    from superlu_dist_tpu_torch.ops.lsum import lsum_panel
    rng = np.random.default_rng(6 + R)
    t, wb, mb, rtrim = 5, 16, 56, 40
    Lp = rng.standard_normal((t, mb, wb)).astype(dtype)
    Li = rng.standard_normal((t, wb, wb)).astype(dtype)
    xb = rng.standard_normal((t, wb, R)).astype(dtype)
    y_off, u_off = 7, 11
    Y = torch.zeros(y_off + t * wb + 1, R, dtype=torch.from_numpy(xb).dtype)
    U = torch.zeros(u_off + t * rtrim + 1, R, dtype=Y.dtype)
    Lpt = torch.from_numpy(Lp)
    lsum_panel(torch.from_numpy(Li), Lpt[:, wb:, :], torch.from_numpy(xb),
               Y, U, y_off, u_off, rtrim)
    y = Y[y_off:y_off + t * wb].numpy().reshape(t, wb, R)
    u = U[u_off:u_off + t * rtrim].numpy().reshape(t, rtrim, R)
    assert not Y[:y_off].any() and not U[:u_off].any()
    L21 = Lp[:, wb:wb + rtrim, :]
    yr, ur = pallas_lsum._oracle()(jnp.asarray(Li), jnp.asarray(L21),
                                   jnp.asarray(xb))
    tol = TOL[np.dtype(dtype)]
    assert rel_maxnorm(y, np.asarray(yr)) < tol
    assert rel_maxnorm(u, np.asarray(ur)) < tol
    if dtype == np.float32:        # the Pallas kernel is f32-only
        try:
            yk, uk = pallas_lsum.lsum_panel(
                jnp.asarray(Li), jnp.asarray(L21), jnp.asarray(xb),
                interpret=True)
        except Exception as e:     # noqa: BLE001 — see _mosaic_bug
            if not _mosaic_bug(e):
                raise
        else:
            assert rel_maxnorm(y, np.asarray(yk)) < tol
            assert rel_maxnorm(u, np.asarray(uk)) < tol


def test_lsum_mixed_precision_promotes():
    """float32 panels against a float64 right-hand side compute in
    float64 (the refinement case), like the reference's einsum
    promotion."""
    from superlu_dist_tpu_torch.ops.lsum import lsum_panel
    rng = np.random.default_rng(3)
    t, wb, mb, rtrim, R = 3, 8, 24, 16, 2
    Lp = rng.standard_normal((t, mb, wb)).astype(np.float32)
    Li = rng.standard_normal((t, wb, wb)).astype(np.float32)
    xb = rng.standard_normal((t, wb, R))
    Y = torch.zeros(t * wb + 1, R, dtype=torch.float64)
    U = torch.zeros(t * rtrim + 1, R, dtype=torch.float64)
    lsum_panel(torch.from_numpy(Li), torch.from_numpy(Lp)[:, wb:, :],
               torch.from_numpy(xb), Y, U, 0, 0, rtrim)
    y = np.einsum("nvw,nwr->nvr", Li.astype(np.float64), xb)
    u = np.einsum("nsw,nwr->nsr", Lp[:, wb:wb + rtrim].astype(np.float64),
                  y)
    assert rel_maxnorm(Y[:t * wb].numpy(), y.reshape(-1, R)) < 1e-13
    assert rel_maxnorm(U[:t * rtrim].numpy(), u.reshape(-1, R)) < 1e-13
