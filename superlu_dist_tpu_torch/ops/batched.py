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

Execution follows the reference's compiled-program layer: the staged
arm runs one program per merged segment of consecutive groups, the
whole-phase arm one program for all of them (`factorize_device`).  A
program is a captured CUDA graph on the card (ops/graphs.py) and the
same Python body run eagerly on the CPU.  The extend-add slab `upd`
is updated in place: the reference donated it into each program so it
streamed through the sequence without a copy, and an in-place update
of one static tensor is the PyTorch form of that.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from .. import flags
from ..device import torch_dtype, upload_int64
from ..plan.plan import FactorPlan
from . import graphs
from .dense_lu import unit_lower_inverse, upper_inverse
from .ea_scatter import (NARROW, EaBucket, destination_lists,
                         ea_scatter_add)
from .panel_lu import launch_plan, partial_lu_batch


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
                 upd_buf: torch.Tensor, thresh, out):
    """One group's numeric factorization.  Reads the children's update
    blocks from `upd_buf` and writes this group's into it, in place,
    and writes the group's (L, U, Li, Ui) panels into the four flat
    views `out`.  `thresh` is a float or a one-element float64 tensor
    on the device.  Returns (tiny, nzero) as device scalars (no host
    sync per group)."""
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

    L, U, Li, Ui = (o.view(shape) for o, shape in zip(
        out, ((n_pad, mb, wb), (n_pad, wb, mb), (n_pad, wb, wb),
              (n_pad, wb, wb))))
    rows = torch.arange(mb, device=device)[:, None]
    colsw = torch.arange(wb, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    torch.where(rows > colsw, F[:, :, :wb], (rows == colsw).to(dtype),
                out=L)
    torch.where(colsw.T <= torch.arange(mb, device=device)[None, :],
                F[:, :wb, :], zero, out=U)
    Li.copy_(unit_lower_inverse(L[:, :wb, :]))
    Ui.copy_(upper_inverse(U[:, :, :wb]))
    if mb > wb:
        rb = mb - wb
        off = g.upd_off_global
        upd_buf[off:off + n_pad * rb * rb].view(n_pad, rb, rb).copy_(
            F[:, wb:, wb:])
    return tiny, nzero


def _group_views(sched: BatchedSchedule, flats) -> list:
    """Per-group (L, U, Li, Ui) views into the four whole-slab flats at
    the groups' cumulative offsets."""
    L, U, Li, Ui = flats
    out = []
    for g in sched.groups:
        n, mb, wb = g.n_loc, g.mb, g.wb
        out.append((L[g.L_off:g.L_off + n * mb * wb],
                    U[g.U_off:g.U_off + n * wb * mb],
                    Li[g.Li_off:g.Li_off + n * wb * wb],
                    Ui[g.Ui_off:g.Ui_off + n * wb * wb]))
    return out


class FactorBuffers:
    """The tensors one factor sweep reads and writes: the scaled values
    with the zero slot appended, the extend-add slab `upd` (streamed
    through the groups in place), the GESP threshold (one float64, read
    by K1 on the device), the (tiny, zero) pivot counters and the four
    panel slabs.  A captured sweep keeps one set as its static tensors;
    an eager sweep makes a fresh one."""

    def __init__(self, sched: BatchedSchedule, nnz: int, dtype,
                 device):
        z = dict(dtype=torch_dtype(dtype), device=device)
        self.vals_ext = torch.zeros(nnz + 1, **z)
        self.upd = torch.zeros(sched.upd_total + sched.upd_pad, **z)
        self.thresh = torch.zeros(1, dtype=torch.float64, device=device)
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self.flats = tuple(torch.empty(n, **z) for n in (
            sched.L_total, sched.U_total, sched.Li_total, sched.Ui_total))
        self.views = _group_views(sched, self.flats)

    def load(self, vals: np.ndarray, thresh: float) -> None:
        """Fill the inputs of one factorization and clear the rest."""
        v = torch.from_numpy(np.ascontiguousarray(vals))
        self.vals_ext[:-1].copy_(v)
        self.thresh.fill_(thresh)
        self.counts.zero_()
        self.upd.zero_()


# --------------------------------------------------------------------
# staged execution and level-merged factor segments: the reference's
# compiled-program layer.  The reference runs one jitted program per
# merged SEGMENT of consecutive groups (buffers donated, so the
# extend-add slab streams through them in place), or, below
# SLU_STAGED_MIN_GROUPS groups, one program for the whole factor
# sweep.  Here each such program is one captured CUDA graph on the
# card (ops/graphs.py) and the same Python body run eagerly on the
# CPU; the member bodies are `factor_group` in schedule order either
# way, so the arms differ only in where the graph boundaries fall.
# --------------------------------------------------------------------

def staged_enabled(sched) -> bool:
    """Use per-segment staged execution?  SLU_STAGED=1 forces on, =0
    forces off; default: on past SLU_STAGED_MIN_GROUPS groups."""
    v = flags.env_str("SLU_STAGED", "auto").strip().lower()
    if v in ("1", "true", "on"):
        return True
    if v in ("0", "false", "off"):
        return False
    try:
        thresh = flags.env_int("SLU_STAGED_MIN_GROUPS", 96)
    except ValueError:
        thresh = 96
    return len(sched.groups) > thresh


FACTOR_MERGE_CELLS_DEFAULT = 65536


def factor_merge_cells() -> int:
    """A factor group whose front-cell count (n_loc · mb · mb) is at or
    below this joins a merged segment (SLU_FACTOR_MERGE_CELLS, default
    65536); 0 gives one group per segment (the reference's legacy
    per-group staged dispatch)."""
    try:
        return max(0, flags.env_int("SLU_FACTOR_MERGE_CELLS",
                                    FACTOR_MERGE_CELLS_DEFAULT))
    except ValueError:
        return FACTOR_MERGE_CELLS_DEFAULT


def factor_seg_cells() -> int:
    """Total front-cell budget of one merged factor segment
    (SLU_FACTOR_SEG_CELLS, default 1048576)."""
    try:
        return max(1, flags.env_int("SLU_FACTOR_SEG_CELLS", 1048576))
    except ValueError:
        return 1048576


def factor_merge_on() -> bool:
    return factor_merge_cells() > 0


def compute_factor_segments(sched, cells: int | None = None,
                            cap: int | None = None) -> list:
    """Group indices per merged segment, in schedule order: groups at
    or below the `cells` bound chain into the open segment until `cap`;
    a large group stands alone."""
    cells = factor_merge_cells() if cells is None else cells
    cap = factor_seg_cells() if cap is None else cap
    segments: list = []
    cur: list = []
    cur_cells = 0
    for gi, g in enumerate(sched.groups):
        c = g.n_loc * g.mb * g.mb
        small = c <= cells
        if cur and ((not small) or cur_cells + c > cap):
            segments.append(cur)
            cur, cur_cells = [], 0
        cur.append(gi)
        cur_cells += c
        if not small:
            segments.append(cur)
            cur, cur_cells = [], 0
    if cur:
        segments.append(cur)
    return segments


def get_factor_segments(sched) -> list:
    """Cached factor segments of a schedule, keyed by the merge knobs
    (a flag change mid-process rebuilds instead of reusing a stale
    layout)."""
    cache = sched.__dict__.setdefault("_factor_segments", {})
    key = (factor_merge_cells(), factor_seg_cells())
    if key not in cache:
        cache[key] = compute_factor_segments(sched)
    return cache[key]


def factor_seg_metas(sched, members, dtype) -> tuple:
    """The static meta tuple of one factor segment's members, in
    schedule order: (mb, wb, n_loc, ea_meta, eb_meta, K1 regime) each.
    The last leg is the port's K1 regime (ops/panel_lu.launch_plan),
    where the reference has its Pallas promotion decision; it shapes
    what a graph captures, so it keys the graph."""
    tdt = torch_dtype(np.dtype(dtype))
    return tuple(
        (g.mb, g.wb, g.n_loc, g.ea_meta, g.eb_meta,
         launch_plan(g.n_loc, g.mb, g.wb, tdt).regime)
        for g in (sched.groups[i] for i in members))


def factor_arm() -> str:
    """One-token name of the factor-sweep arm: "merged" (segments of
    several groups) or "legacy" (one group per segment)."""
    return "merged" if factor_merge_on() else "legacy"


def factor_graph_key(sched, seg, dtype) -> tuple:
    """The graph key of one factor segment: its members and their
    metas.  A graph bakes its operands' addresses, so unlike the
    reference's jit key it names the members, not their shapes
    alone."""
    return (tuple(seg), factor_seg_metas(sched, seg, dtype))


def _staged_factor_segment(sched, members, buf: FactorBuffers) -> None:
    """The factor sweep over `members` (group indices in schedule order)
    on the buffers: one staged segment's body, and over every group the
    whole phase's."""
    for i in members:
        g = sched.groups[i]
        t, z = factor_group(g, buf.vals_ext, buf.upd, buf.thresh,
                            buf.views[i])
        buf.counts += torch.stack((t, z))


def _factor_graphs(sched, nnz: int, dtype, device, staged: bool):
    """The GraphSet of a (schedule, dtype, arm): the staged segments'
    graphs or the whole-phase graph, with one FactorBuffers."""
    key = (("staged", np.dtype(dtype).str) if staged
           else ("phase", np.dtype(dtype).str, "merged"))
    return graphs.graph_set(
        sched, key, device,
        lambda: FactorBuffers(sched, nnz, dtype, device))


def _factor_programs(sched, dtype, staged: bool, buf: FactorBuffers):
    """[(graph key, body)] of one factor sweep on `buf`: one program
    per merged segment (`staged`), or one for all groups."""
    if not staged:
        return [("all", partial(_staged_factor_segment, sched,
                                range(len(sched.groups)), buf))]
    return [(factor_graph_key(sched, seg, dtype),
             partial(_staged_factor_segment, sched, seg, buf))
            for seg in get_factor_segments(sched)]


def _staged_factor_run(sched, vals, thresh: float, dtype, device,
                       staged: bool = True, eager: bool = False):
    """One factor sweep by the staged or the whole-phase arm.  Returns
    (flats, counts): the four panel slabs, the caller's own (on the
    card a copy of the graphs' static slabs), and the (tiny, zero)
    counters as a device tensor, for the caller to read once."""
    if eager or not graphs.on_card(device):
        buf = FactorBuffers(sched, len(vals), dtype, device)
        buf.load(vals, thresh)
        for _, body in _factor_programs(sched, dtype, staged, buf):
            body()
        return buf.flats, buf.counts
    gset = _factor_graphs(sched, len(vals), dtype, device, staged)
    buf = gset.static
    with gset.lock:
        buf.load(vals, thresh)
        for key, body in _factor_programs(sched, dtype, staged, buf):
            gset.run(key, body)
        counts = buf.counts.clone()
        # a replay writes the same addresses every time: the handle
        # takes its own copy of the slabs
        return tuple(f.clone() for f in buf.flats), counts


def capture_staged(plan: FactorPlan, dtype, device) -> int:
    """Capture every staged segment graph of the plan's schedule for
    `dtype` on the card without running it (utils/warmup.py).  Returns
    the number of graphs captured now."""
    sched = get_schedule(plan)
    device = torch.device(device)
    sched.to_device(device)
    gset = _factor_graphs(sched, len(plan.coo_rows), dtype, device, True)
    with gset.lock:
        return sum(gset.capture(key, body) for key, body in
                   _factor_programs(sched, dtype, True, gset.static))


@dataclasses.dataclass
class StagedLU:
    """Device factors in per-group panels (the staged arm):
    panels[i] = (L, U, Li, Ui) group-local flats of group i.
    Concatenated in group order they are the DeviceLU slab layout
    (offsets L_off, U_off, Li_off, Ui_off are cumulative in group
    order)."""
    plan: FactorPlan
    schedule: BatchedSchedule
    dtype: np.dtype
    panels: list
    tiny_pivots: int

    @property
    def device(self) -> torch.device:
        return self.panels[0][0].device

    def flats(self):
        """The DeviceLU form: (L, U, Li, Ui) whole-slab flats."""
        return tuple(torch.cat([p[i] for p in self.panels])
                     for i in range(4))

    def held_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for p in self.panels for a in p)


@dataclasses.dataclass
class DeviceLU:
    """Device factors as four flat slabs (the whole-phase arm; the
    reference's dLocalLU_t analog), each group's panels at its
    cumulative offsets."""
    plan: FactorPlan
    schedule: BatchedSchedule
    dtype: np.dtype
    L_flat: torch.Tensor
    U_flat: torch.Tensor
    Li_flat: torch.Tensor
    Ui_flat: torch.Tensor
    tiny_pivots: int

    @property
    def device(self) -> torch.device:
        return self.L_flat.device

    def flats(self):
        return (self.L_flat, self.U_flat, self.Li_flat, self.Ui_flat)

    @property
    def panels(self) -> list:
        """Per-group (L, U, Li, Ui) views into the slabs (StagedLU's
        layout)."""
        return _group_views(self.schedule, self.flats())


def _phase_fns(sched, dtype, device):
    """The whole-phase programs of a (schedule, dtype): `factor(vals,
    thresh)` runs the whole factor sweep as one program (on the card
    one graph, captured once per (schedule, dtype) key) and returns
    (flats, counts) as `_staged_factor_run` does; the solve of its
    handles is the packed solve (trisolve.solve_packed), whose graphs
    belong to the handle whose slabs they read."""
    def factor(vals, thresh, eager=False):
        return _staged_factor_run(sched, vals, thresh, dtype, device,
                                  staged=False, eager=eager)
    from . import trisolve
    return factor, trisolve.solve_packed


def factorize_device(plan: FactorPlan, scaled_vals: np.ndarray,
                     dtype=np.float64, device="cuda",
                     eager: bool = False):
    """Numeric factorization of the plan's scaled values: the staged
    arm (one program per merged segment, a StagedLU) past
    SLU_STAGED_MIN_GROUPS groups or under SLU_STAGED=1, else the
    whole-phase arm (one program, a DeviceLU).  On the card each
    program is a CUDA graph, captured at its first use; `eager=True`
    runs the same bodies eagerly there instead (the oracle of the card
    tests and chip_smoke.py).  Raises ZeroDivisionError on an
    exactly-zero pivot when tiny-pivot replacement is off (the
    reference's info=i signal)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        raise NotImplementedError(
            "complex factorization is not ported yet (ROADMAP queue 1 "
            "item 10, complex and pair lanes)")
    sched = get_schedule(plan)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    vals = np.asarray(scaled_vals).astype(dtype)
    thresh = _thresh_for(plan, dtype)
    # every index set is on the device before any capture
    sched.to_device(device)
    staged = staged_enabled(sched)
    if staged:
        flats, counts = _staged_factor_run(sched, vals, thresh, dtype,
                                           device, eager=eager)
    else:
        factor, _ = _phase_fns(sched, dtype, device)
        flats, counts = factor(vals, thresh, eager=eager)
    tiny, nzero = counts.tolist()
    if nzero > 0:
        raise ZeroDivisionError(
            f"factorization hit {nzero} exactly-zero pivot(s); "
            "the matrix is singular (enable replace_tiny_pivot to "
            "perturb instead)")
    if staged:
        return StagedLU(plan=plan, schedule=sched, dtype=dtype,
                        panels=_group_views(sched, flats),
                        tiny_pivots=tiny)
    return DeviceLU(plan, sched, dtype, *flats, tiny_pivots=tiny)


# --------------------------------------------------------------------
# the solve entry points
# --------------------------------------------------------------------

def _solve_device_common(lu, b: np.ndarray, trans: bool,
                         eager: bool = False) -> np.ndarray:
    """Routed as the reference routes it: a StagedLU through the staged
    segment sweeps, a DeviceLU through the packed solve."""
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
    bt = torch.from_numpy(np.ascontiguousarray(bb.astype(xdt)))
    if isinstance(lu, StagedLU):
        X = trisolve.staged_sweeps(lu, bt, trans, eager=eager)
    else:
        X = trisolve.solve_packed(lu, bt, trans, eager=eager)
    out = X.cpu().numpy()
    return out[:, 0] if squeeze else out


def solve_device(lu, b: np.ndarray, eager: bool = False) -> np.ndarray:
    """b in factor ordering, (n,) or (n, nrhs); returns same shape."""
    return _solve_device_common(lu, b, trans=False, eager=eager)


def solve_device_trans(lu, b: np.ndarray,
                       eager: bool = False) -> np.ndarray:
    """Solve Mᵀ·x = b (factor ordering): forward with Uᵀ, backward
    with Lᵀ over the same group schedule."""
    return _solve_device_common(lu, b, trans=True, eager=eager)
