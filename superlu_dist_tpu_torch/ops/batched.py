"""Level-batched bucketed multifrontal execution on one device.

The device engine replacing the reference's pdgstrf hot loop
(SRC/pdgstrf.c:1108) and tree factorization
(SRC/dtreeFactorization.c:265): the supernodal etree is executed
level-synchronously from the leaves; within a level, all fronts with
the same padded bucket shape (wb, mb) form one group and run batched:

    scatter-assemble A entries + identity padding
    → extend-add of the children's update blocks
      (element lane: kernel K2, ops/ea_scatter.py; block lane: slices)
    → batched blocked partial LU (kernel K1, ops/panel_lu.py)
    → L/U panels + diagonal-block inverses (ops/dense_lu.py)
    → the group's update blocks into the flat extend-add slab

All indices are precomputed on the host once per pattern
(BatchedSchedule, cached on the FactorPlan — the SamePattern rung).
The schedule builder is the reference package's `build_schedule` at
one device: its zone, cooperative and sharded branches never engage
there and are left out, and every index array equals the reference's
(tests/test_torch_schedule.py).

Execution is eager, one group at a time, with the extend-add slab
`upd_buf` updated in place: the reference donated the slab into each
staged group program so it streamed through the sequence without a
copy; an in-place update of one tensor is the PyTorch form of that.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import torch_dtype, upload_int64
from ..plan.plan import FactorPlan
from .dense_lu import unit_lower_inverse, upper_inverse
from .ea_scatter import (NARROW, EaBucket, destination_lists,
                         ea_scatter_add)
from .panel_lu import partial_lu_batch


def _next_bucket(x: int) -> int:
    """Next length in the {2^k, 1.5·2^k} grid — ≤33% padding waste
    while keeping the distinct-shape set logarithmic."""
    if x <= 1:
        return 1
    p = 1 << (x - 1).bit_length()      # next pow2 ≥ x
    mid = p // 2 + p // 4              # 1.5·(p/2), the grid midpoint
    return mid if x <= mid else p


def _pad_idx(arr: np.ndarray, fill: int) -> np.ndarray:
    """Pad an index array to the next {2^k, 1.5·2^k} length (padded
    entries carry drop/zero indices)."""
    n = max(len(arr), 1)
    target = _next_bucket(n)
    out = np.full(target, fill, dtype=np.int64)
    out[:len(arr)] = arr
    return out


def _pad_pos(pos: np.ndarray, w: int, wb: int) -> np.ndarray:
    """Unpadded front position -> padded front position (pivot block
    padded from w to wb shifts the struct rows up by wb-w)."""
    return np.where(pos < w, pos, pos + (wb - w))


@dataclasses.dataclass
class GroupDev:
    """One group's index sets on the device, filtered once on the host
    so no operation ever sees an out-of-bounds index: torch has no
    drop mode, where the reference relied on `.at[].add(mode="drop")`
    to discard padding lanes."""
    a_src: torch.Tensor          # (La',) into vals_ext
    a_dst: torch.Tensor          # (La',) flat front indices, unique
    one_dst: torch.Tensor        # (Lo',) identity-padding diagonal
    ea: list                     # per element bucket: EaBucket
    eb: list                     # per block bucket: (li, lj, st, recs)


@dataclasses.dataclass
class GroupSpec:
    """One (level, bucket) batch of fronts.  Index arrays are host
    numpy, int64 (the reference stacks them (ndev, ...); at one device
    the leading axis is dropped)."""
    level: int
    mb: int
    wb: int
    n_loc: int                 # fronts in the batch (padded)
    n_true: int                # true front count
    sup_ids: np.ndarray
    sup_pos: np.ndarray        # batch slot per sup_ids entry
    a_src: np.ndarray          # (La,) into vals (+ zero slot at nnz)
    a_dst: np.ndarray          # (La,) flat front indices, padding
                               # distinct out of bounds (f_loc + i)
    one_dst: np.ndarray        # (Lo,) same padding convention
    # element extend-add lane, outer-product form: per bucket
    # (so, st, db, pr) — child slab offset, slab row stride, front
    # base, and the rc_b destination positions (sentinel mb)
    ea_hosts: tuple
    ea_meta: tuple             # per-bucket (rc_b, K, nreal)
    col_idx: np.ndarray        # (n_loc, wb) global cols, pad -> n
    struct_idx: np.ndarray     # (n_loc, mb-wb) pad -> n
    upd_off_global: int        # start of this group's update slab
    L_off: int                 # flat offsets of the group's panels
    U_off: int
    Li_off: int
    Ui_off: int
    # block-copy extend-add lane: children whose positions are a few
    # long contiguous runs move as 2-D block copies; per bucket key
    # (li, lj, st): (so, dr, dc, w) — source offset, destination row
    # in the (n_loc·mb, mb) front view, destination column, and a 0/1
    # mask for K-padding records
    eb_hosts: tuple = ()
    eb_meta: tuple = ()        # per-bucket (li, lj, st, K)
    _dev: Optional[dict] = dataclasses.field(default=None, repr=False)

    def _dev_parts(self):
        """(host int64 arrays, make) where make(tensors) builds the
        GroupDev from those arrays' device copies, in order."""
        f_loc = self.n_loc * self.mb * self.mb
        keep = self.a_dst < f_loc
        arrays = [self.a_src[keep], self.a_dst[keep],
                  self.one_dst[self.one_dst < f_loc]]
        rcs = []
        for (rc_b, K, nreal), (so, st, db, pr) in zip(
                self.ea_meta, self.ea_hosts):
            if nreal == 0:
                continue
            # K-padding records (all-sentinel positions) change nothing;
            # only the real records go to the device.  Records are
            # front-sorted, so each front's records form one contiguous
            # range [seg[f], seg[f+1]).
            dbr = db[:nreal]
            fb = dbr // (self.mb * self.mb)
            starts = np.flatnonzero(np.r_[True, fb[1:] != fb[:-1]])
            part = [so[:nreal], st[:nreal], dbr, pr[:nreal], fb[starts],
                    np.r_[starts, nreal]]
            if rc_b <= NARROW:
                part += destination_lists(so[:nreal], st[:nreal], dbr,
                                          pr[:nreal], self.mb)
            arrays += part
            rcs.append((int(rc_b), len(part)))
        eb = []
        for (li, lj, st, K), (so, dr, dc, w) in zip(self.eb_meta,
                                                    self.eb_hosts):
            live = np.flatnonzero(w)
            eb.append((int(li), int(lj), int(st),
                       [(int(so[i]), int(dr[i]), int(dc[i]))
                        for i in live]))

        def make(ts):
            ea, i = [], 3
            for rc, n in rcs:
                ea.append(EaBucket(rc, *ts[i:i + n]))
                i += n
            return GroupDev(a_src=ts[0], a_dst=ts[1], one_dst=ts[2],
                            ea=ea, eb=eb)
        return arrays, make

    def dev(self, device) -> GroupDev:
        """Device index sets, built and cached once per device
        (BatchedSchedule.to_device builds every group's at once)."""
        if self._dev is None:
            self._dev = {}
        key = str(torch.device(device))
        if key not in self._dev:
            arrays, make = self._dev_parts()
            self._dev[key] = make(upload_int64(arrays, device))
        return self._dev[key]


@dataclasses.dataclass
class BatchedSchedule:
    groups: List[GroupSpec]    # execution order, levels ascending
    n: int
    upd_total: int             # update-slab size (elements)
    L_total: int               # flat panel sizes
    U_total: int
    Li_total: int
    Ui_total: int
    # tail padding of the update slab (elements): a block-lane record
    # reads its (li, lj) sub-block out of li·st slab elements whose
    # last row runs up to st−lj past the child's slab; the pad keeps
    # every such read inside the buffer.  1 when no block lane exists.
    upd_pad: int = 1

    def to_device(self, device) -> None:
        """Every group's device index sets, uploaded in one copy."""
        key = str(torch.device(device))
        todo = [g for g in self.groups if key not in (g._dev or {})]
        parts = [g._dev_parts() for g in todo]
        ts = upload_int64([a for arrays, _ in parts for a in arrays],
                          device)
        i = 0
        for g, (arrays, make) in zip(todo, parts):
            if g._dev is None:
                g._dev = {}
            g._dev[key] = make(ts[i:i + len(arrays)])
            i += len(arrays)


# minimum contiguous-run length routed to the block lane (the
# reference's SLU_EA_BLOCK_MIN_RUN default): shorter runs stay on the
# element lane, where one copy per run would dominate
_EA_BLOCK_MIN_RUN = 8


def _coalesce_buckets(by_bucket: dict, limit: float) -> dict:
    """Cost-bounded coalescing of one level's {(wb, mb): [sup...]}
    bucket groups into fewer padded groups.

    A merged frame holds every member's true panel and struct extents:
    wb = max panel bucket and rb = max struct capacity (mb − wb) over
    the members.  Greedy ascending scan: buckets join the open
    super-bucket while the accumulated padded/original cell ratio
    stays within `limit`.  Distinct greedy groups that close with the
    same padded frame fold into one group.

    build_schedule does not merge levels yet (one group per (wb, mb)
    bucket); level merging is queued in ROADMAP.md, and this planner
    is held to the reference's by the schedule tests."""
    def cells(nf, wb_, rb_):
        mb_ = wb_ + rb_
        return nf * (2 * wb_ * mb_ + rb_ * rb_)

    items = sorted(
        ((wb0, mb0 - wb0, len(sl), sl)
         for (wb0, mb0), sl in by_bucket.items()),
        key=lambda t: (t[0], t[1]))
    merged: dict = {}

    def close(cur):
        merged.setdefault((cur[0], cur[0] + cur[1]),
                          []).extend(cur[3])

    cur = None      # [wb_m, rb_m, orig_cells, slist]
    for wb0, rb0, nf, sl in items:
        if cur is not None:
            wb_m = max(cur[0], wb0)
            rb_m = max(cur[1], rb0)
            newc = cells(len(cur[3]) + nf, wb_m, rb_m)
            if newc <= limit * (cur[2] + cells(nf, wb0, rb0)):
                cur[0], cur[1] = wb_m, rb_m
                cur[2] += cells(nf, wb0, rb0)
                cur[3] = cur[3] + sl
                continue
            close(cur)
        cur = [wb0, rb0, cells(nf, wb0, rb0), list(sl)]
    if cur is not None:
        close(cur)
    return merged


def _contig_runs(pos) -> list:
    """Maximal runs of consecutive (+1-stepping) values in `pos`:
    [(start_index, length), ...] covering the whole vector."""
    pos = np.asarray(pos)
    if len(pos) == 0:
        return []
    brk = np.flatnonzero(np.diff(pos) != 1)
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [len(pos)]])
    return [(int(s), int(e - s)) for s, e in zip(starts, ends)]


def _plan_child_blocks(ps_row, min_run: int = _EA_BLOCK_MIN_RUN,
                       max_runs: int = 4):
    """Block-copy eligibility of one child's position vector: the run
    list [(i0, len)] when every maximal run is ≥ min_run and there are
    ≤ max_runs of them, else None (the element lane)."""
    runs = _contig_runs(ps_row)
    if not runs or len(runs) > max_runs:
        return None
    if any(ln < min_run for _, ln in runs):
        return None
    return runs


def build_schedule(plan: FactorPlan) -> BatchedSchedule:
    fp = plan.frontal
    part = fp.sym.part
    xsup = part.xsup
    n = plan.n
    nnz = len(plan.coo_rows)

    max_blk_stride = 0           # sizes the upd-slab tail pad

    sup_upd_off = np.full(fp.nsuper, -1, dtype=np.int64)
    groups: List[GroupSpec] = []
    L_cur = U_cur = Li_cur = Ui_cur = 0

    # liveness-based update-slab allocator: a group's slab is dead once
    # every front in it has been consumed by its parent's extend-add,
    # so slab address space is reused through a first-fit free list
    holes: List[tuple] = []          # (offset, size), disjoint, sorted
    upd_peak = 0
    group_alloc: dict = {}           # group idx -> (offset, size)
    remaining: dict = {}             # group idx -> unconsumed fronts
    group_of_sup: dict = {}          # front -> group idx

    def _free(gi: int):
        off, size = group_alloc[gi]
        if size == 0:
            return
        holes.append((off, size))
        holes.sort()
        merged = [holes[0]]
        for o, s in holes[1:]:       # coalesce adjacent holes
            po, ps = merged[-1]
            if po + ps == o:
                merged[-1] = (po, ps + s)
            else:
                merged.append((o, s))
        holes[:] = merged

    def _alloc(size: int) -> int:
        nonlocal upd_peak
        if size == 0:
            return 0
        for i, (o, s) in enumerate(holes):
            if s >= size:
                if s == size:
                    holes.pop(i)
                else:
                    holes[i] = (o + size, s - size)
                return o
        # reclaim the tail hole if it touches the peak
        if holes and holes[-1][0] + holes[-1][1] == upd_peak:
            o, s = holes.pop()
            upd_peak = o + size
            return o
        o = upd_peak
        upd_peak += size
        return o

    for lv, sups in enumerate(fp.level_supernodes):
        by_bucket = {}
        for s in sups:
            by_bucket.setdefault((int(fp.wb[s]), int(fp.mb[s])),
                                 []).append(int(s))
        for (wb, mb), slist in sorted(by_bucket.items()):
            N = len(slist)
            rb = mb - wb
            n_loc = _next_bucket(N)
            f_loc = n_loc * mb * mb

            # consume child slabs (each front is extend-added exactly
            # once, here); fully-consumed groups free their slab for
            # reuse — overlap with this group's own slab is safe
            # because the assembly reads happen before the slab write
            for s in slist:
                for c in fp.sym.children[s]:
                    if fp.r[c] > 0:
                        gc = group_of_sup[c]
                        remaining[gc] -= 1
                        if remaining[gc] == 0:
                            _free(gc)
            slab_sz = n_loc * rb * rb
            upd_off = _alloc(slab_sz)

            sup_pos = np.empty(len(slist), dtype=np.int64)
            a_src_l, a_dst_l, one_l = [], [], []
            # extend-add child records, outer-product form: per child
            # only (rc, slab offset, slab stride, front base, positions)
            child_recs = []
            # block-copy records (li, lj, st, src_off, dst_row, dst_col)
            blk_recs = []
            col_idx = np.full((n_loc, wb), n, dtype=np.int64)
            struct_idx = np.full((n_loc, rb), n, dtype=np.int64)

            for b, s in enumerate(slist):
                w = int(fp.w[s]); r = int(fp.r[s])
                base = b * mb * mb
                lr = _pad_pos(fp.a_lr[s], w, wb)
                lc = _pad_pos(fp.a_lc[s], w, wb)
                a_src_l.append(fp.a_src[s])
                a_dst_l.append(base + lr * mb + lc)
                if wb > w:
                    t = np.arange(w, wb)
                    one_l.append(base + t * mb + t)
                for c in fp.sym.children[s]:
                    rc = int(fp.r[c])
                    if rc == 0:
                        continue
                    # slab row stride the child was written with:
                    # its own bucket's rb
                    rbc = int(fp.mb[c]) - int(fp.wb[c])
                    coff = sup_upd_off[c]
                    if coff < 0:
                        raise RuntimeError("child scheduled after parent")
                    ps_row = _pad_pos(fp.ea_map[c], w, wb)
                    runs = _plan_child_blocks(ps_row)
                    if runs is not None:
                        # run × run sub-blocks of the rc×rc update move
                        # as contiguous 2-D copies (slab rows at stride
                        # rbc; dest rows/cols are the runs' positions)
                        max_blk_stride = max(max_blk_stride, int(rbc))
                        for (i0, li) in runs:
                            for (j0, lj) in runs:
                                blk_recs.append(
                                    (li, lj, int(rbc),
                                     int(coff) + i0 * rbc + j0,
                                     base // mb + int(ps_row[i0]),
                                     int(ps_row[j0])))
                    else:
                        child_recs.append((rc, int(coff), rbc, base,
                                           ps_row))
                col_idx[b, :w] = np.arange(xsup[s], xsup[s] + w)
                struct_idx[b, :r] = fp.sym.struct[s]
                sup_upd_off[s] = upd_off + b * rb * rb
                sup_pos[b] = b
            # dummy fronts: identity pivot block so the padded LU is
            # well-defined
            for b in range(N, n_loc):
                t = np.arange(wb)
                one_l.append(b * mb * mb + t * mb + t)

            # bucket the child records by padded rc.  K is rounded to
            # the reference's chunk multiple (C children per chunk,
            # C·rc_b² ≤ 2^22) so the index arrays equal the
            # reference's; the port runs each bucket as one kernel
            # launch and needs no chunking.
            by_rc: dict = {}
            for rec in child_recs:
                by_rc.setdefault(_next_bucket(rec[0]), []).append(rec)
            ea_hosts, ea_meta = [], []
            for rc_b in sorted(by_rc):
                recs = by_rc[rc_b]
                K = _next_bucket(len(recs))
                C = max(1, (1 << 22) // (rc_b * rc_b))
                if K > C:
                    K = -(-K // C) * C
                so = np.zeros(K, dtype=np.int64)
                st = np.zeros(K, dtype=np.int64)
                db = np.zeros(K, dtype=np.int64)
                # row/col position == mb is the padding sentinel
                pr = np.full((K, rc_b), mb, dtype=np.int64)
                for i, (rc, coff, stride, base, ps_row) in enumerate(recs):
                    so[i] = coff
                    st[i] = stride
                    db[i] = base
                    pr[i, :rc] = ps_row
                # K-padding records repeat the last real front base:
                # their positions are all sentinel, so they change
                # nothing, and db stays non-decreasing
                nreal = len(recs)
                if 0 < nreal < K:
                    db[nreal:] = db[nreal - 1]
                ea_hosts.append((so, st, db, pr))
                ea_meta.append((rc_b, K, nreal))

            # bucket the block-copy records by exact (li, lj, stride);
            # K pads to the size grid with masked no-ops
            by_blk: dict = {}
            for rec in blk_recs:
                by_blk.setdefault(rec[:3], []).append(rec)
            eb_hosts, eb_meta = [], []
            for (bli, blj, bst) in sorted(by_blk):
                recs = by_blk[(bli, blj, bst)]
                K = _next_bucket(len(recs))
                so = np.zeros(K, dtype=np.int64)
                dr = np.zeros(K, dtype=np.int64)
                dc = np.zeros(K, dtype=np.int64)
                wm = np.zeros(K, dtype=np.int64)
                for i, (_, _, _, soff, drow, dcol) in enumerate(recs):
                    so[i] = soff
                    dr[i] = drow
                    dc[i] = dcol
                    wm[i] = 1
                eb_hosts.append((so, dr, dc, wm))
                eb_meta.append((bli, blj, bst, K))

            def stack(lst, fill, distinct_pad=False):
                """Concatenate and pad to the size grid; distinct_pad
                gives every padding slot its own out-of-bounds
                destination (f_loc + i)."""
                c = (np.concatenate(lst) if lst
                     else np.empty(0, dtype=np.int64))
                p = _pad_idx(c, fill)
                if distinct_pad:
                    bad = np.flatnonzero(p == fill)
                    p[bad] = fill + np.arange(len(bad))
                return p

            a_src = stack(a_src_l, nnz)
            a_dst = stack(a_dst_l, f_loc, distinct_pad=True)
            # sort the assembly pairs by destination (adds commute)
            o = np.argsort(a_dst, kind="stable")
            groups.append(GroupSpec(
                level=lv, mb=mb, wb=wb, n_loc=n_loc, n_true=N,
                sup_ids=np.asarray(slist, dtype=np.int64),
                sup_pos=sup_pos,
                a_src=a_src[o], a_dst=a_dst[o],
                one_dst=stack(one_l, f_loc, distinct_pad=True),
                ea_hosts=tuple(ea_hosts), ea_meta=tuple(ea_meta),
                eb_hosts=tuple(eb_hosts), eb_meta=tuple(eb_meta),
                col_idx=col_idx, struct_idx=struct_idx,
                upd_off_global=upd_off,
                L_off=L_cur, U_off=U_cur, Li_off=Li_cur, Ui_off=Ui_cur))
            gi = len(groups) - 1
            group_alloc[gi] = (upd_off, slab_sz)
            for s in slist:
                group_of_sup[s] = gi
            nread = sum(1 for s in slist if fp.r[s] > 0)
            remaining[gi] = nread
            if nread == 0:
                _free(gi)
            L_cur += n_loc * mb * wb
            U_cur += n_loc * wb * mb
            Li_cur += n_loc * wb * wb
            Ui_cur += n_loc * wb * wb

    return BatchedSchedule(groups=groups, n=n, upd_total=upd_peak,
                           L_total=L_cur, U_total=U_cur,
                           Li_total=Li_cur, Ui_total=Ui_cur,
                           upd_pad=1 + max_blk_stride)


def get_schedule(plan: FactorPlan) -> BatchedSchedule:
    """The plan's schedule, built once and cached on the plan."""
    sched = plan.__dict__.get("_batched_schedule")
    if sched is None:
        sched = plan.__dict__["_batched_schedule"] = build_schedule(plan)
    return sched


def _thresh_for(plan: FactorPlan, dtype) -> float:
    """GESP tiny-pivot threshold sqrt(eps)·‖A‖ (0 when replacement is
    off)."""
    if not plan.options.replace_tiny_pivot:
        return 0.0
    eps = float(np.finfo(np.dtype(dtype)).eps)
    return float(np.sqrt(eps) * plan.anorm)


# --------------------------------------------------------------------
# the factor half
# --------------------------------------------------------------------

def _ea_add_blocks(F2: torch.Tensor, upd_buf: torch.Tensor,
                   eb: list) -> None:
    """Block-copy extend-add lane, in place: each record adds one
    contiguous (li, lj) sub-block of a child update (slab rows at
    stride st) into the (n_loc·mb, mb) front view.  Records run in
    order, so overlapping destination blocks accumulate correctly."""
    for li, lj, st, recs in eb:
        for so, dr, dc in recs:
            F2[dr:dr + li, dc:dc + lj] += upd_buf.as_strided(
                (li, lj), (st, 1), so)


def factor_group(g: GroupSpec, vals_ext: torch.Tensor,
                 upd_buf: torch.Tensor, thresh: float):
    """One group's numeric factorization.  Reads the children's update
    blocks from `upd_buf` and writes this group's into it, in place.
    Returns ((L, U, Li, Ui) group-local flats, tiny, nzero) with the
    counters as device scalars (no host sync per group)."""
    dtype = upd_buf.dtype
    device = upd_buf.device
    d = g.dev(device)
    mb, wb, n_pad = g.mb, g.wb, g.n_loc
    Ff = torch.zeros(n_pad * mb * mb, dtype=dtype, device=device)
    # a_dst is unique (one front slot per stored entry), so an indexed
    # store onto zeros is the reference's scatter-add
    Ff[d.a_dst] = vals_ext[d.a_src]
    Ff.index_fill_(0, d.one_dst, 1)
    F = Ff.view(n_pad, mb, mb)
    for b in d.ea:
        ea_scatter_add(F, upd_buf, b)
    _ea_add_blocks(Ff.view(n_pad * mb, mb), upd_buf, d.eb)
    F, tiny, nzero = partial_lu_batch(F, thresh, wb=wb)

    rows = torch.arange(mb, device=device)[:, None]
    colsw = torch.arange(wb, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    Lpanel = torch.where(rows > colsw, F[:, :, :wb],
                         (rows == colsw).to(dtype))
    Upanel = torch.where(colsw.T <= torch.arange(mb, device=device)[None, :],
                         F[:, :wb, :], zero)
    Li = unit_lower_inverse(Lpanel[:, :wb, :])
    Ui = upper_inverse(Upanel[:, :, :wb])
    if mb > wb:
        rb = mb - wb
        off = g.upd_off_global
        upd_buf[off:off + n_pad * rb * rb].view(n_pad, rb, rb).copy_(
            F[:, wb:, wb:])
    panels = (Lpanel.reshape(-1), Upanel.reshape(-1),
              Li.reshape(-1), Ui.reshape(-1))
    return panels, tiny, nzero


@dataclasses.dataclass
class StagedLU:
    """Device factors in per-group panels: panels[i] = (L, U, Li, Ui)
    group-local flats of group i.  Concatenated in group order they
    are the reference's DeviceLU flat slab layout (offsets L_off,
    U_off, Li_off, Ui_off are cumulative in group order)."""
    plan: FactorPlan
    schedule: BatchedSchedule
    dtype: np.dtype
    panels: list
    tiny_pivots: int
    _packs: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.panels[0][0].device

    def flats(self):
        """The reference's DeviceLU form: (L, U, Li, Ui) whole-slab
        flats."""
        return tuple(torch.cat([p[i] for p in self.panels])
                     for i in range(4))


def factorize_device(plan: FactorPlan, scaled_vals: np.ndarray,
                     dtype=np.float64, device="cuda") -> StagedLU:
    """Numeric factorization of the plan's scaled values, one group at
    a time.  Raises ZeroDivisionError on an exactly-zero pivot when
    tiny-pivot replacement is off (the reference's info=i signal)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        raise NotImplementedError(
            "complex factorization is not ported yet (ROADMAP queue 1 "
            "item 10, complex and pair lanes)")
    sched = get_schedule(plan)
    tdt = torch_dtype(dtype)
    device = torch.device(device)
    vals = torch.as_tensor(np.asarray(scaled_vals).astype(dtype))
    vals_ext = torch.cat([vals, torch.zeros(1, dtype=tdt)]).to(device)
    upd_buf = torch.zeros(sched.upd_total + sched.upd_pad, dtype=tdt,
                          device=device)
    thresh = _thresh_for(plan, dtype)
    sched.to_device(device)
    panels = []
    tiny = torch.zeros((), dtype=torch.int64, device=device)
    nzero = torch.zeros((), dtype=torch.int64, device=device)
    for g in sched.groups:
        p, t, z = factor_group(g, vals_ext, upd_buf, thresh)
        panels.append(p)
        tiny += t
        nzero += z
    del upd_buf
    nzero = int(nzero)
    if nzero > 0:
        raise ZeroDivisionError(
            f"factorization hit {nzero} exactly-zero pivot(s); "
            "the matrix is singular (enable replace_tiny_pivot to "
            "perturb instead)")
    return StagedLU(plan=plan, schedule=sched, dtype=dtype,
                    panels=panels, tiny_pivots=int(tiny))


# --------------------------------------------------------------------
# the solve entry points
# --------------------------------------------------------------------

def _solve_device_common(lu: StagedLU, b: np.ndarray,
                         trans: bool) -> np.ndarray:
    from . import trisolve
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    # promote rather than cast: a float64 residual against float32
    # factors solves in float64 (the sweep reads the float32 panels)
    xdt = np.promote_types(lu.dtype, bb.dtype)
    if xdt.kind == "c":
        raise NotImplementedError(
            "complex right-hand sides are not ported yet (ROADMAP "
            "queue 1 item 10, complex and pair lanes)")
    ts = trisolve.get_trisolve(lu.schedule)
    packs = trisolve.get_packs(lu)
    bt = torch.as_tensor(np.ascontiguousarray(bb.astype(xdt))).to(
        lu.device)
    X = trisolve.sweep(ts, packs, bt, trans)
    out = X.cpu().numpy()
    return out[:, 0] if squeeze else out


def solve_device(lu: StagedLU, b: np.ndarray) -> np.ndarray:
    """b in factor ordering, (n,) or (n, nrhs); returns same shape."""
    return _solve_device_common(lu, b, trans=False)


def solve_device_trans(lu: StagedLU, b: np.ndarray) -> np.ndarray:
    """Solve Mᵀ·x = b (factor ordering): forward with Uᵀ, backward
    with Lᵀ over the same group schedule."""
    return _solve_device_common(lu, b, trans=True)
