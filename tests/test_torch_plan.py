"""Host plan parity: the port's FactorPlan equals the JAX package's on
the same matrix — every integer array exactly, the scalings to 0 ulp
(they come from the same numpy code) — and interop carries a JAX plan
across intact."""

import numpy as np
import pytest

from torch_port_util import MATRICES, flatten, jax_plan, matrix_pair

INT_FIELDS = ("perm_r", "perm_c", "post", "final_row", "final_col",
              "coo_rows", "coo_cols")


def _assert_plans_equal(pj, pt):
    assert pt.n == pj.n and pt.equed == pj.equed
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
    # scalings: bit-identical
    np.testing.assert_array_equal(pt.row_scale, pj.row_scale)
    np.testing.assert_array_equal(pt.col_scale, pj.col_scale)
    assert pt.anorm == pj.anorm
    fj, ft = pj.frontal, pt.frontal
    for f in ("w", "r", "m", "wb", "mb"):
        np.testing.assert_array_equal(getattr(ft, f), getattr(fj, f),
                                      err_msg=f)
    for f in ("I", "a_src", "a_lr", "a_lc", "ea_map",
              "level_supernodes"):
        lj, lt = getattr(fj, f), getattr(ft, f)
        assert len(lj) == len(lt), f
        for x, y in zip(lt, lj):
            np.testing.assert_array_equal(x, y, err_msg=f)
    sj, stt = fj.sym, ft.sym
    for f in ("xsup", "supno", "sparent", "levels"):
        np.testing.assert_array_equal(getattr(stt.part, f),
                                      getattr(sj.part, f), err_msg=f)
    for f in ("struct", "children"):
        for x, y in zip(getattr(stt, f), getattr(sj, f)):
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert ft.factor_flops == fj.factor_flops
    assert pt.lu_nnz() == pj.lu_nnz()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_matches_reference(name):
    import superlu_dist_tpu_torch as st
    aj, at = matrix_pair(name)
    pj = jax_plan(aj)
    pt = st.plan_factorization(at, st.Options(), device="cpu")
    _assert_plans_equal(pj, pt)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_carried_across_builds_the_same_schedule(name):
    """interop.plan_from_arrays round-trips a JAX plan: the port's
    schedule built from it equals the one built from the port's own
    plan of the same matrix."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.ops.batched import build_schedule
    aj, at = matrix_pair(name)
    pj = jax_plan(aj)
    carried = interop.plan_from_arrays(flatten(pj), device="cpu")
    own = st.plan_factorization(at, st.Options(), device="cpu")
    _assert_plans_equal(pj, carried)
    assert carried.options == own.options
    sa, sb = build_schedule(carried), build_schedule(own)
    assert len(sa.groups) == len(sb.groups)
    assert (sa.upd_total, sa.upd_pad, sa.L_total) == (
        sb.upd_total, sb.upd_pad, sb.L_total)
    for ga, gb in zip(sa.groups, sb.groups):
        for f in ("a_src", "a_dst", "one_dst", "col_idx", "struct_idx"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
        assert ga.ea_meta == gb.ea_meta and ga.eb_meta == gb.eb_meta
        for ha, hb in zip(ga.ea_hosts, gb.ea_hosts):
            for x, y in zip(ha, hb):
                np.testing.assert_array_equal(x, y)


def test_native_passes_match_python_twins(monkeypatch):
    """The port's own native host library and the pure-Python plan
    passes agree on etree, postorder, column counts, supernodes and
    symbolic structure (the library is an accelerator, never a
    requirement)."""
    import scipy.sparse as sp
    from superlu_dist_tpu_torch.plan import etree, supernodes, symbolic
    from superlu_dist_tpu_torch.utils import native
    _, at = matrix_pair("convdiff12")
    A = at.to_scipy()
    B = ((abs(A) + abs(A).T) + sp.eye(at.n)).tocsr()
    B.sort_indices()
    ip, ix = B.indptr.astype(np.int64), B.indices.astype(np.int64)

    def passes():
        parent = etree.etree_symmetric(ip, ix, at.n)
        post = etree.postorder(parent)
        cc = etree.col_counts_postordered(ip, ix, parent)
        part = supernodes.find_supernodes(parent, cc, 8, 64)
        sym = symbolic.symbolic_factorize(ip, ix, part, threads=1)
        return parent, post, cc, part, sym

    assert native.available()
    got = passes()
    monkeypatch.setattr(native, "native_or_none", lambda: None)
    ref = passes()
    for x, y in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[3].xsup, ref[3].xsup)
    np.testing.assert_array_equal(got[3].sparent, ref[3].sparent)
    for x, y in zip(got[4].struct, ref[4].struct):
        np.testing.assert_array_equal(x, y)
