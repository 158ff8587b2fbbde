"""Schedule parity: every index array of every GroupSpec and of the
TrisolveSchedule the port builds equals the JAX package's at one
device (the JAX arrays carry a leading ndev=1 axis)."""

import numpy as np
import pytest

from torch_port_util import MATRICES, jax_plan, matrix_pair, ported_plan


def _schedules(name):
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    aj, _ = matrix_pair(name)
    pj = jax_plan(aj)
    sj = jb.build_schedule(pj, 1)
    st = tb.build_schedule(ported_plan(pj))
    return sj, st


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_group_specs_match_reference(name):
    sj, st = _schedules(name)
    assert len(st.groups) == len(sj.groups)
    assert (st.upd_total, st.upd_pad, st.L_total, st.U_total,
            st.Li_total, st.Ui_total) == (
        sj.upd_total, sj.upd_pad, sj.L_total, sj.U_total, sj.Li_total,
        sj.Ui_total)
    for gj, gt in zip(sj.groups, st.groups):
        assert (gt.level, gt.mb, gt.wb, gt.n_loc, gt.n_true) == (
            gj.level, gj.mb, gj.wb, gj.n_loc, gj.n_true)
        assert (gt.upd_off_global, gt.L_off, gt.U_off, gt.Li_off,
                gt.Ui_off) == (gj.upd_off_global, gj.L_off, gj.U_off,
                               gj.Li_off, gj.Ui_off)
        np.testing.assert_array_equal(gt.sup_ids, gj.sup_ids)
        np.testing.assert_array_equal(gt.sup_pos, gj.sup_pos)
        for f in ("a_src", "a_dst", "one_dst", "col_idx", "struct_idx"):
            np.testing.assert_array_equal(getattr(gt, f),
                                          getattr(gj, f)[0], err_msg=f)
        # element lane: (rc_b, tc_b, K, C) vs (rc_b, K, nreal)
        assert len(gt.ea_meta) == len(gj.ea_meta)
        for (rc_b, K, nreal), (jrc, jtc, jK, _) in zip(gt.ea_meta,
                                                       gj.ea_meta):
            assert (rc_b, K) == (jrc, jK) and jtc == jrc
            assert 0 < nreal <= K
        for ht, hj in zip(gt.ea_hosts, gj.ea_hosts):
            so, st_, db, pr = ht
            jso, jst, jdb, jpr, jpc = hj
            np.testing.assert_array_equal(so, jso[0])
            np.testing.assert_array_equal(st_, jst[0])
            np.testing.assert_array_equal(db, jdb[0])
            np.testing.assert_array_equal(pr, jpr[0])
            np.testing.assert_array_equal(pr, jpc[0])
        assert gt.eb_meta == tuple(gj.eb_meta)
        for ht, hj in zip(gt.eb_hosts, gj.eb_hosts):
            for x, y in zip(ht, hj):
                np.testing.assert_array_equal(x, y[0])


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_trisolve_layout_matches_reference(name):
    from superlu_dist_tpu.ops import trisolve as jt
    from superlu_dist_tpu_torch.ops import trisolve as tt
    sj, st = _schedules(name)
    tsj, tst = jt.build_trisolve(sj), tt.build_trisolve(st)
    assert (tst.y_total, tst.u_total) == (tsj.y_total, tsj.u_total)
    np.testing.assert_array_equal(tst.final_idx, tsj.final_idx)
    for gj, gt in zip(tsj.groups, tst.groups):
        assert (gt.gi, gt.trim, gt.rtrim, gt.J, gt.y_off, gt.u_off) == (
            gj.gi, gj.trim, gj.rtrim, gj.J, gj.y_off, gj.u_off)
        np.testing.assert_array_equal(gt.b_idx, gj.b_idx[0])
        np.testing.assert_array_equal(gt.u_gidx, gj.u_gidx[0])
        np.testing.assert_array_equal(gt.xs_idx, gj.xs_idx[0])


def test_group_dev_filters_padding_once():
    """GroupSpec.dev drops the out-of-bounds assembly padding and the
    K-padding extend-add records on the host, and segments the
    front-sorted records per front."""
    import torch
    _, st = _schedules("lap3d6")
    cpu = torch.device("cpu")
    for g in st.groups:
        d = g.dev(cpu)
        f_loc = g.n_loc * g.mb * g.mb
        assert int(d.a_dst.max()) < f_loc
        if d.one_dst.numel():
            assert int(d.one_dst.max()) < f_loc
        nreal = [m[2] for m in g.ea_meta]
        assert [b.so.numel() for b in d.ea] == [n for n in nreal if n]
        for b in d.ea:
            seg = b.seg.numpy()
            assert seg[0] == 0 and seg[-1] == b.so.numel()
            fb = b.db.numpy() // (g.mb * g.mb)
            for f, lo, hi in zip(b.fronts.numpy(), seg[:-1], seg[1:]):
                assert (fb[lo:hi] == f).all()
        assert g.dev(cpu) is d


def test_block_lane_always_planned():
    """The block-copy extend-add lane has no switch: the unsymmetric
    matrix's contiguous child runs land in block records, and every
    child with update rows is planned in exactly one lane."""
    _, st = _schedules("convdiff12")
    assert sum(len(g.eb_meta) for g in st.groups) > 0
    assert st.upd_pad > 1


def _level_buckets(name):
    aj, _ = matrix_pair(name)
    fp = ported_plan(jax_plan(aj)).frontal
    for sups in fp.level_supernodes:
        by_bucket = {}
        for s in sups:
            by_bucket.setdefault((int(fp.wb[s]), int(fp.mb[s])),
                                 []).append(int(s))
        if len(by_bucket) > 1:
            yield by_bucket


@pytest.mark.parametrize("limit", [1.0, 1.5, 4.0, 1e9])
@pytest.mark.parametrize("name", ["lap3d6", "convdiff12"])
def test_coalesce_buckets_matches_reference(name, limit):
    """The level-merging planner coalesces each etree level's buckets
    exactly as the reference's does, and keeps every front."""
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops import batched as tb
    levels = list(_level_buckets(name))
    assert levels
    for by_bucket in levels:
        got = tb._coalesce_buckets(by_bucket, limit)
        assert got == jb._coalesce_buckets(by_bucket, limit)
        assert sorted(s for sl in got.values() for s in sl) == sorted(
            s for sl in by_bucket.values() for s in sl)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_row_maps_sorted_below_mb(name):
    """What the extend-add kernel's wide variant relies on: every real
    record's row map is strictly increasing below mb, then sentinel mb
    to the end, on the host arrays (equal to the reference's) and on
    the device copies.  So a binary search of the map finds exactly the
    child rows that land in a band of parent rows."""
    import torch
    _, st = _schedules(name)
    cpu = torch.device("cpu")
    nrec = 0
    for g in st.groups:
        live = [m for m in g.ea_meta if m[2]]
        for (rc_b, K, nreal), (_, _, _, pr), b in zip(
                live, [h for h, m in zip(g.ea_hosts, g.ea_meta) if m[2]],
                g.dev(cpu).ea):
            np.testing.assert_array_equal(b.pr.numpy(), pr[:nreal])
            for row in pr[:nreal]:
                rc = int(np.sum(row < g.mb))
                assert rc > 0
                assert (row[rc:] == g.mb).all()
                assert (np.diff(row[:rc]) > 0).all() and row[rc - 1] < g.mb
                for r0 in range(0, g.mb, 32):
                    r1 = min(r0 + 32, g.mb)
                    lo, hi = np.searchsorted(row, [r0, r1])
                    np.testing.assert_array_equal(
                        np.arange(lo, hi),
                        np.flatnonzero((row >= r0) & (row < r1)))
                nrec += 1
    assert nrec > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ea_scatter_plain_matches_reference_schedule(name, dtype):
    """Every element bucket of the parity schedules: the port's plain
    extend-add (the CPU side of kernel K2) against the reference's
    element lane (`.at[].add` with mode="drop") on the same fronts and
    slab."""
    import jax.numpy as jnp
    import torch
    from superlu_dist_tpu.ops import batched as jb
    from superlu_dist_tpu_torch.ops.ea_scatter import ea_scatter_add
    from torch_port_util import TOL, rel_maxnorm
    sj, st = _schedules(name)
    rng = np.random.default_rng(5)
    slab = rng.standard_normal(st.upd_total + st.upd_pad).astype(dtype)
    nb = 0
    for gj, gt in zip(sj.groups, st.groups):
        if not gt.ea_meta:
            continue
        F0 = rng.standard_normal((gt.n_loc, gt.mb, gt.mb)).astype(dtype)
        Ft = torch.from_numpy(F0.copy())
        for b in gt.dev(torch.device("cpu")).ea:
            ea_scatter_add(Ft, torch.from_numpy(slab), b)
            nb += 1
        blocks = tuple(tuple(jnp.asarray(a) for a in h)
                       for h in gj.ea_hosts)
        ref = jb._ea_add(jnp.asarray(F0.reshape(-1)), jnp.asarray(slab),
                         blocks, tuple(gj.ea_meta), mb=gt.mb,
                         n_pad=gt.n_loc, allow_pallas=False)
        assert rel_maxnorm(Ft.numpy().reshape(-1),
                           np.asarray(ref)) < TOL[np.dtype(dtype)]
    assert nb > 0


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_destination_lists_match_int64_arrays(name):
    """The per-destination lists the extend-add kernel reads for narrow
    buckets hold exactly the live lanes of the bucket's int64 arrays:
    every (destination, slab source) pair once, the sources of one
    destination in record order (the first two inline, the rest in the
    side list).  Replaying them as the kernel does (F + first value +
    later values) equals the plain version bit for bit."""
    import torch
    from superlu_dist_tpu_torch.ops.ea_scatter import (
        NARROW, ea_scatter_add_plain, flat_indices)
    _, st = _schedules(name)
    rng = np.random.default_rng(9)
    slab = torch.from_numpy(rng.standard_normal(st.upd_total + st.upd_pad))
    n = 0
    for g in st.groups:
        for b in g.dev(torch.device("cpu")).ea:
            if b.rc_b > NARROW:
                assert b.head_dst is None
                continue
            F = torch.from_numpy(rng.standard_normal((g.n_loc, g.mb, g.mb)))
            dst, src = (t.numpy() for t in flat_indices(F, b))
            order = np.argsort(dst, kind="stable")
            hd, hs = b.head_dst.numpy(), b.head_src.numpy()
            hs2, xp, xs = (b.head_src2.numpy(), b.xptr.numpy(),
                           b.xsrc.numpy())
            srcs = [[s0] + ([s1] if s1 >= 0 else []) + list(xs[a:c])
                    for s0, s1, a, c in zip(hs, hs2, xp[:-1], xp[1:])]
            assert all(s1 >= 0 or a == c for s1, a, c in
                       zip(hs2, xp[:-1], xp[1:]))
            np.testing.assert_array_equal(np.concatenate(srcs),
                                          src[order])
            np.testing.assert_array_equal(
                np.repeat(hd, [len(x) for x in srcs]), dst[order])
            assert len(np.unique(hd)) == len(hd)
            ref = F.clone()
            ea_scatter_add_plain(ref, slab, b)
            Ff, s = F.view(-1).numpy().copy(), slab.numpy()
            for d, sl in zip(hd, srcs):
                v = Ff[d]
                for x in sl:
                    v += s[x]
                Ff[d] = v
            np.testing.assert_array_equal(Ff, ref.view(-1).numpy())
            n += 1
    assert n > 0
