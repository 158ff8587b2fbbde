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

Level merging (SLU_LEVEL_MERGE=1, `_coalesce_buckets`) folds a level's
buckets into fewer padded groups; a front is then written into the
update slab at its group's stride, which its parent reads
(`sup_slab_rb`).

Pair storage (SLU_COMPLEX_PAIR=1, `_pair_mode`): a complex system's
values, update slab and factor flats are (2, N) real planes, as in the
reference.  Assembly and extend-add run plane by plane (K2's real
lane: extend-add is linear and structural); the partial LU runs on K1's
complex lane over a complex working front filled from the planes and
written back to them.  A pair handle is solved through complex panels
decoded from its planes once (`solve_panels`).  The reference kept its
pair programs free of complex operations for the TPU's lowering; here
the kernels' complex lanes run instead.
"""

from __future__ import annotations

import dataclasses
import threading
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from .. import flags
from ..device import (dtype_info, resolve_device, solve_dtype,
                      torch_dtype, upload_int64)
from ..plan.plan import FactorPlan
from . import graphs
from .dense_lu import unit_lower_inverse, upper_inverse
from .ea_scatter import (NARROW, EaBucket, destination_lists,
                         ea_scatter_add)
from .pair_lu import (partial_lu_pair_batch, unit_lower_inverse_pair,
                      upper_inverse_pair)
from .panel_lu import launch_plan, partial_lu_batch


def _pair_mode(dtype) -> bool:
    """Factor a complex system on stacked real/imag planes (pair
    storage) instead of native complex storage: SLU_COMPLEX_PAIR=1 and
    a complex `dtype`."""
    return (dtype_info(dtype).is_complex
            and flags.env_str("SLU_COMPLEX_PAIR", "0") == "1")


def _real_dtype(dtype):
    """The real dtype of `dtype`'s precision (a handle dtype: numpy, or
    torch.bfloat16)."""
    return dtype_info(dtype).real.handle


def _lu_is_pair(lu) -> bool:
    """Factors stored as (2, N) real planes (pair storage), not as 1-D
    flats: the handle's storage, whatever SLU_COMPLEX_PAIR says now."""
    first = lu.panels[0][0] if isinstance(lu, StagedLU) else lu.L_flat
    return first.dim() == 2


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


def _level_merge_on() -> bool:
    """SLU_LEVEL_MERGE=1: coalesce each etree level's bucket groups
    (`_coalesce_buckets`).  Off by default, as in the reference: the
    merged frames pay padded flops and slab for fewer groups."""
    return flags.env_str("SLU_LEVEL_MERGE", "0") == "1"


def _level_merge_limit() -> float:
    """Padded/original cell-ratio bound of level merging
    (SLU_LEVEL_MERGE_LIMIT, default 1.5, at least 1)."""
    try:
        v = flags.env_float("SLU_LEVEL_MERGE_LIMIT", 1.5)
    except ValueError:
        v = 1.5
    return max(1.0, v)


def _coalesce_buckets(by_bucket: dict, limit: float) -> dict:
    """Cost-bounded coalescing of one level's {(wb, mb): [sup...]}
    bucket groups into fewer padded groups.

    A merged frame holds every member's true panel and struct extents:
    wb = max panel bucket and rb = max struct capacity (mb − wb) over
    the members.  Greedy ascending scan: buckets join the open
    super-bucket while the accumulated padded/original cell ratio
    stays within `limit`.  Distinct greedy groups that close with the
    same padded frame fold into one group.

    build_schedule calls it per level under SLU_LEVEL_MERGE=1."""
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
    # slab row stride each front was written with: its group's rb, which
    # under level merging can exceed the front's own bucket's
    # (fp.mb − fp.wb); a parent reads the child's slab at this stride
    sup_slab_rb = np.zeros(fp.nsuper, dtype=np.int64)
    merge = _level_merge_on()
    limit = _level_merge_limit()
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
        if merge and len(by_bucket) > 1:
            by_bucket = _coalesce_buckets(by_bucket, limit)
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
                    # slab row stride the child was written with: its
                    # group's rb
                    rbc = int(sup_slab_rb[c])
                    coff = sup_upd_off[c]
                    if coff < 0:
                        raise RuntimeError("child scheduled after parent")
                    gp = groups[group_of_sup[c]]
                    if rbc != gp.mb - gp.wb or rbc < rc:
                        raise RuntimeError(
                            f"slab stride of front {c} ({rbc}) does not "
                            f"match its group's rb ({gp.mb - gp.wb}) or "
                            f"holds fewer than its {rc} update rows")
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
                sup_slab_rb[s] = rb
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
    """The plan's schedule, built once per level-merge setting and
    cached on the plan, so a mid-process change of SLU_LEVEL_MERGE or
    its limit builds a fresh one."""
    cache = plan.__dict__.setdefault("_batched_schedules", {})
    key = _level_merge_limit() if _level_merge_on() else None
    if key not in cache:
        cache[key] = build_schedule(plan)
    return cache[key]


def _thresh_for(plan: FactorPlan, dtype) -> float:
    """GESP tiny-pivot threshold sqrt(eps)·‖A‖ (0 when replacement is
    off)."""
    if not plan.options.replace_tiny_pivot:
        return 0.0
    eps = dtype_info(dtype).eps
    return float(np.sqrt(eps) * plan.anorm)


# --------------------------------------------------------------------
# the factor half
# --------------------------------------------------------------------

def _ea_add_blocks(F2: torch.Tensor, upd_buf: torch.Tensor,
                   eb: list) -> None:
    """Block-copy extend-add lane, in place: each record adds one
    contiguous (li, lj) sub-block of a child update (slab rows at
    stride st) into the (n_loc·mb, mb) front view.  Records run in
    order, so overlapping destination blocks accumulate correctly.
    `upd_buf` may be a view (a pair storage's plane): offsets count
    from its first element."""
    base = upd_buf.storage_offset()
    for li, lj, st, recs in eb:
        for so, dr, dc in recs:
            F2[dr:dr + li, dc:dc + lj] += upd_buf.as_strided(
                (li, lj), (st, 1), base + so)


def _assemble(g: GroupSpec, d: GroupDev, vals_ext: torch.Tensor,
              upd_buf: torch.Tensor, one: bool = True) -> torch.Tensor:
    """The group's fronts (n_loc · mb · mb, flat) of one plane: A's
    entries, the identity padding (`one`: not on an imaginary plane),
    then the children's update blocks (K2 for the element buckets,
    slices for the block records)."""
    mb, n_pad = g.mb, g.n_loc
    Ff = torch.zeros(n_pad * mb * mb, dtype=upd_buf.dtype,
                     device=upd_buf.device)
    # a_dst is unique (one front slot per stored entry), so an indexed
    # store onto zeros is the reference's scatter-add
    Ff[d.a_dst] = vals_ext[d.a_src]
    if one:
        Ff.index_fill_(0, d.one_dst, 1)
    F = Ff.view(n_pad, mb, mb)
    for b in d.ea:
        ea_scatter_add(F, upd_buf, b)
    _ea_add_blocks(Ff.view(n_pad * mb, mb), upd_buf, d.eb)
    return Ff


def _encode_into(planes: torch.Tensor, c: torch.Tensor) -> None:
    """Write the complex tensor `c` into the (2, c.numel()) planes."""
    planes[0].copy_(c.real.reshape(-1))
    planes[1].copy_(c.imag.reshape(-1))


def factor_group(g: GroupSpec, vals_ext: torch.Tensor,
                 upd_buf: torch.Tensor, thresh, out):
    """One group's numeric factorization.  Reads the children's update
    blocks from `upd_buf` and writes this group's into it, in place,
    and writes the group's (L, U, Li, Ui) panels into the four flat
    views `out`.  `thresh` is a float or a one-element float64 tensor
    on the device.  Returns (tiny, nzero) as device scalars (no host
    sync per group).

    Pair storage (`upd_buf` (2, ·) real planes): each plane is
    assembled and extend-added alone (K2's real lane).  On the card the
    complex working front `torch.complex(F_re, F_im)` goes through K1's
    complex lane and the complex inverses, and every result is written
    back to the planes; on the CPU the planes go through ops/pair_lu,
    the plain version of that path (`_factor_pair_plain`)."""
    device = upd_buf.device
    d = g.dev(device)
    mb, wb, n_pad = g.mb, g.wb, g.n_loc
    pair = upd_buf.dim() == 2
    if pair:
        planes = (_assemble(g, d, vals_ext[0], upd_buf[0]),
                  _assemble(g, d, vals_ext[1], upd_buf[1], one=False))
        if device.type == "cpu":
            return _factor_pair_plain(g, torch.stack(planes), thresh,
                                      upd_buf, out)
        F = torch.complex(*planes)
    else:
        F = _assemble(g, d, vals_ext, upd_buf)
    dtype = F.dtype
    F, tiny, nzero = partial_lu_batch(F.view(n_pad, mb, mb), thresh,
                                      wb=wb)

    shapes = ((n_pad, mb, wb), (n_pad, wb, mb), (n_pad, wb, wb),
              (n_pad, wb, wb))
    if pair:
        L, U, Li, Ui = (torch.empty(sh, dtype=dtype, device=device)
                        for sh in shapes)
    else:
        L, U, Li, Ui = (o.view(sh) for o, sh in zip(out, shapes))
    rows = torch.arange(mb, device=device)[:, None]
    colsw = torch.arange(wb, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    torch.where(rows > colsw, F[:, :, :wb], (rows == colsw).to(dtype),
                out=L)
    torch.where(colsw.T <= torch.arange(mb, device=device)[None, :],
                F[:, :wb, :], zero, out=U)
    Li.copy_(unit_lower_inverse(L[:, :wb, :]))
    Ui.copy_(upper_inverse(U[:, :, :wb]))
    if pair:
        for o, c in zip(out, (L, U, Li, Ui)):
            _encode_into(o, c)
    if mb > wb:
        rb = mb - wb
        off = g.upd_off_global
        sl = upd_buf[..., off:off + n_pad * rb * rb]
        if pair:
            _encode_into(sl, F[:, wb:, wb:])
        else:
            sl.view(n_pad, rb, rb).copy_(F[:, wb:, wb:])
    return tiny, nzero


def _factor_pair_plain(g: GroupSpec, Fp: torch.Tensor, thresh,
                       upd_buf: torch.Tensor, out):
    """factor_group's pair storage on the CPU: the assembled planes Fp
    (2, n_loc · mb · mb) factored in pair arithmetic (ops/pair_lu), the
    panels, inverses and update slab written to the planes.  Returns
    (tiny, nzero)."""
    mb, wb, n_pad = g.mb, g.wb, g.n_loc
    F, tiny, nzero = partial_lu_pair_batch(Fp.view(2, n_pad, mb, mb),
                                           thresh, wb=wb)
    rows = torch.arange(mb)[:, None]
    colsw = torch.arange(wb)[None, :]
    zero = torch.zeros((), dtype=F.dtype)
    L = torch.where(rows > colsw, F[..., :wb], zero)
    L[0] += (rows == colsw).to(F.dtype)          # unit diagonal
    U = torch.where(colsw.T <= torch.arange(mb)[None, :],
                    F[:, :, :wb, :], zero)
    for o, p in zip(out, (L, U, unit_lower_inverse_pair(L[:, :, :wb, :]),
                          upper_inverse_pair(U[..., :wb]))):
        o.copy_(p.reshape(2, -1))
    if mb > wb:
        rb = mb - wb
        off = g.upd_off_global
        upd_buf[:, off:off + n_pad * rb * rb].view(2, n_pad, rb, rb).copy_(
            F[:, :, wb:, wb:])
    return tiny, nzero


def _group_views(sched: BatchedSchedule, flats) -> list:
    """Per-group (L, U, Li, Ui) views into the four whole-slab flats at
    the groups' cumulative offsets."""
    L, U, Li, Ui = flats
    out = []
    for g in sched.groups:
        n, mb, wb = g.n_loc, g.mb, g.wb
        out.append((L[..., g.L_off:g.L_off + n * mb * wb],
                    U[..., g.U_off:g.U_off + n * wb * mb],
                    Li[..., g.Li_off:g.Li_off + n * wb * wb],
                    Ui[..., g.Ui_off:g.Ui_off + n * wb * wb]))
    return out


class FactorBuffers:
    """The tensors one factor sweep reads and writes: the scaled values
    with the zero slot appended, the extend-add slab `upd` (streamed
    through the groups in place), the GESP threshold (one float64, read
    by K1 on the device), the (tiny, zero) pivot counters and the four
    panel slabs.  A captured sweep keeps one set as its static tensors;
    an eager sweep makes a fresh one.  With `pair` (pair storage of a
    complex `dtype`) the values, the slab and the panel slabs are
    (2, ·) planes of the real dtype of `dtype`'s precision."""

    def __init__(self, sched: BatchedSchedule, nnz: int, dtype,
                 device, pair: bool = False):
        self.pair = bool(pair)
        lead = (2,) if pair else ()
        z = dict(dtype=torch_dtype(_real_dtype(dtype) if pair else dtype),
                 device=device)
        self.vals_ext = torch.zeros(lead + (nnz + 1,), **z)
        self.upd = torch.zeros(lead + (sched.upd_total + sched.upd_pad,),
                               **z)
        self.thresh = torch.zeros(1, dtype=torch.float64, device=device)
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self.flats = tuple(torch.empty(lead + (n,), **z) for n in (
            sched.L_total, sched.U_total, sched.Li_total, sched.Ui_total))
        self.views = _group_views(sched, self.flats)

    def load(self, vals, thresh: float) -> None:
        """Fill the inputs of one factorization and clear the rest.
        `vals` (the scaled values in plan COO order) is numpy or a
        tensor, on the host or already on the device; it is cast to the
        factor dtype on the way in (to its planes under pair
        storage)."""
        if not isinstance(vals, torch.Tensor):
            vals = torch.from_numpy(np.ascontiguousarray(vals))
        if self.pair:
            if vals.is_complex():
                _encode_into(self.vals_ext[:, :-1], vals)
            else:
                self.vals_ext[0, :-1].copy_(vals)
                self.vals_ext[1, :-1].zero_()
        else:
            self.vals_ext[:-1].copy_(vals)
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
    tdt = torch_dtype(dtype)
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


def _factor_graphs(sched, nnz: int, dtype, device, staged: bool,
                   pair: bool = False):
    """The GraphSet of a (schedule, dtype, storage, arm): the staged
    segments' graphs or the whole-phase graph, with one FactorBuffers."""
    name = dtype_info(dtype).name
    key = (("staged", name, pair) if staged
           else ("phase", name, pair, "merged"))
    return graphs.graph_set(
        sched, key, device,
        lambda: FactorBuffers(sched, nnz, dtype, device, pair))


def _factor_programs(sched, dtype, staged: bool, buf: FactorBuffers):
    """[(graph key, body)] of one factor sweep on `buf`: one program
    per merged segment (`staged`), or one for all groups."""
    if not staged:
        return [("all", partial(_staged_factor_segment, sched,
                                range(len(sched.groups)), buf))]
    return [(factor_graph_key(sched, seg, dtype),
             partial(_staged_factor_segment, sched, seg, buf))
            for seg in get_factor_segments(sched)]


def _factor_sweep(sched, dtype, staged: bool, buf: FactorBuffers,
                  gset=None) -> None:
    """One factor sweep on the loaded `buf`: as the graphs of `gset`
    (whose lock the caller holds; `buf` is its static set), or eagerly
    when there is none."""
    for key, body in _factor_programs(sched, dtype, staged, buf):
        if gset is None:
            body()
        else:
            gset.run(key, body)


def _staged_factor_run(sched, vals, thresh: float, dtype, device,
                       staged: bool = True, eager: bool = False,
                       pair: bool = False):
    """One factor sweep by the staged or the whole-phase arm, on native
    or (`pair`) plane storage.  Returns (flats, counts): the four panel
    slabs, the caller's own (on the card a copy of the graphs' static
    slabs), and the (tiny, zero) counters as a device tensor, for the
    caller to read once."""
    if eager or not graphs.on_card(device):
        buf = FactorBuffers(sched, len(vals), dtype, device, pair)
        buf.load(vals, thresh)
        _factor_sweep(sched, dtype, staged, buf)
        return buf.flats, buf.counts
    gset = _factor_graphs(sched, len(vals), dtype, device, staged, pair)
    buf = gset.static
    with gset.lock:
        buf.load(vals, thresh)
        _factor_sweep(sched, dtype, staged, buf, gset)
        counts = buf.counts.clone()
        # a replay writes the same addresses every time: the handle
        # takes its own copy of the slabs
        return tuple(f.clone() for f in buf.flats), counts


def capture_staged(plan: FactorPlan, dtype, device) -> int:
    """Capture every staged segment graph of the plan's schedule for
    `dtype` (and its storage, `_pair_mode`) on the card without running
    it (utils/warmup.py).  Returns the number of graphs captured now."""
    sched = get_schedule(plan)
    device = torch.device(device)
    sched.to_device(device)
    gset = _factor_graphs(sched, len(plan.coo_rows), dtype, device, True,
                          _pair_mode(dtype))
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
        return tuple(torch.cat([p[i] for p in self.panels], dim=-1)
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


def _phase_fns(sched, dtype, device, pair: bool):
    """The whole-phase programs of a (schedule, dtype, storage):
    `factor(vals, thresh)` runs the whole factor sweep as one program
    (on the card one graph, captured once per (schedule, dtype,
    storage) key) and returns (flats, counts) as `_staged_factor_run`
    does; `solve(lu, b, trans)` is the SLU_TRISOLVE arm's solve of its
    handles (trisolve.solve), whose graphs belong to the handle whose
    slabs they read."""
    def factor(vals, thresh, eager=False):
        return _staged_factor_run(sched, vals, thresh, dtype, device,
                                  staged=False, eager=eager, pair=pair)
    from . import trisolve
    return factor, trisolve.solve


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
    reference's info=i signal).  Under SLU_COMPLEX_PAIR=1 a complex
    `dtype` factors on pair storage: the handle's flats are (2, N)
    real planes.  A bfloat16 `dtype` factors in bfloat16 storage
    (K1–K3's bf16 lanes; the handle's dtype is torch.bfloat16, which
    numpy lacks)."""
    dtype = dtype_info(dtype).handle
    pair = _pair_mode(dtype)
    sched = get_schedule(plan)
    device = resolve_device(device)
    # cast where numpy can; bfloat16 values are rounded once as they
    # enter the factor buffers
    vals = np.asarray(scaled_vals)
    if isinstance(dtype, np.dtype):
        vals = vals.astype(dtype)
    thresh = _thresh_for(plan, dtype)
    # every index set is on the device before any capture
    sched.to_device(device)
    staged = staged_enabled(sched)
    if staged:
        flats, counts = _staged_factor_run(sched, vals, thresh, dtype,
                                           device, eager=eager, pair=pair)
    else:
        factor, _ = _phase_fns(sched, dtype, device, pair)
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

def solve_panels(lu) -> list:
    """The per-group (L, U, Li, Ui) flats a handle is solved with: its
    panels, or for a pair-stored handle complex flats decoded from its
    planes, made once and cached on the handle (`decode_pair` refreshes
    them in place)."""
    if not _lu_is_pair(lu):
        return lu.panels
    cplx = lu.__dict__.get("_pair_decoded")
    if cplx is None:
        cdt = torch_dtype(lu.dtype)
        cplx = lu.__dict__["_pair_decoded"] = [
            tuple(torch.empty(p.shape[-1], dtype=cdt, device=p.device)
                  for p in grp) for grp in lu.panels]
        decode_pair(lu)
    return cplx


def decode_pair(lu) -> None:
    """Copy a pair handle's planes into its complex solve flats
    (`solve_panels`), in place: two strided copies a flat."""
    for grp, cg in zip(lu.panels, lu.__dict__["_pair_decoded"]):
        for p, c in zip(grp, cg):
            r = torch.view_as_real(c)
            r[:, 0].copy_(p[0])
            r[:, 1].copy_(p[1])


def _solve_device_common(lu, b: np.ndarray, trans: bool,
                         eager: bool = False) -> np.ndarray:
    """Routed as the reference routes it, on the SLU_TRISOLVE arm: a
    StagedLU through the staged sweeps (per merged segment, or per
    group on the legacy arm), a DeviceLU through one program for the
    whole sweep (the packed solve, or the legacy sweep).  A pair-stored
    handle is solved through its complex decode (`solve_panels`),
    whatever SLU_COMPLEX_PAIR says now."""
    from . import trisolve
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    # promote rather than cast: a float64 residual against float32
    # factors solves in float64 (the sweep reads the float32 panels),
    # a complex right-hand side against real factors in complex, and a
    # bfloat16 factor's right-hand side in at least float32
    xdt = solve_dtype(lu.dtype, bb.dtype)
    bt = torch.from_numpy(np.ascontiguousarray(bb)).to(xdt)
    X = trisolve.solve(lu, bt, trans, eager=eager)
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


# --------------------------------------------------------------------
# the fused solver: factor, solve and refinement on the device
# --------------------------------------------------------------------
#
# The reference traces the whole numeric pipeline into one XLA program
# (`make_fused_step`), and with refinement (`make_fused_solver`) runs
# its loop as a `while_loop` whose stop the data decides.  A CUDA graph
# has no data-dependent loop, so here each iteration is the context's
# solve programs and one small update program, each a graph on the
# card, and the host reads one pinned pair (stop flag, berr) after the
# update: the host loop the reference's staged arm runs, with the same
# decisions.

class FusedContext:
    """What the fused steps of one (schedule, factor dtype, storage,
    arm) share on one device.

    * The factor sweep's buffers: on the card the static FactorBuffers
      of the factor graph set that `factorize` replays too (one capture
      serves both), with its lock.
    * A handle (StagedLU on the staged arm, DeviceLU on the whole-phase
      arm) whose panels are views of those static slabs, not a copy,
      and which is never handed out.
    * That handle's solve programs per (nrhs, solve dtype, solve arm),
      and the refinement programs of the steps (`refinement`).
    * Under pair storage (`pair`) the handle's complex solve flats
      (`solve_panels`), refreshed from the planes after every factor
      sweep by one more program (`decode_pair`).

    A call holds `lock` from loading the values to copying out its
    results: a factorization held elsewhere owns a copy of the slabs
    and is never touched, and no two calls share the buffers at once.
    On the CPU, or with `eager`, the same bodies run eagerly on buffers
    of the context's own."""

    def __init__(self, plan: FactorPlan, dtype, device, staged: bool,
                 eager: bool, pair: bool = False):
        sched = get_schedule(plan)
        sched.to_device(device)          # before any capture
        self.plan, self.sched = plan, sched
        self.dtype = dtype_info(dtype).handle
        self.device = torch.device(device)
        self.staged = bool(staged)
        self.pair = bool(pair)
        self.eager = eager or not graphs.on_card(device)
        nnz = len(plan.coo_rows)
        if self.eager:
            self.fset = None
            self.buf = FactorBuffers(sched, nnz, self.dtype, device,
                                     self.pair)
            self.lock = threading.Lock()
        else:
            self.fset = _factor_graphs(sched, nnz, self.dtype, device,
                                       self.staged, self.pair)
            self.buf = self.fset.static
            self.lock = self.fset.lock
        if self.staged:
            self.lu = StagedLU(plan=plan, schedule=sched, dtype=self.dtype,
                               panels=self.buf.views, tiny_pivots=0)
        else:
            self.lu = DeviceLU(plan, sched, self.dtype, *self.buf.flats,
                               tiny_pivots=0)
        if self.pair:
            solve_panels(self.lu)       # allocated before any capture
        self._solvers: dict = {}
        self._refinements: dict = {}

    def factor(self, scaled, thresh: float) -> None:
        """Factor the scaled values (plan COO order, a device tensor or
        numpy) into the static slabs, and under pair storage decode
        them into the handle's complex solve flats; the pivot counters
        stay in `buf.counts`.  The caller holds `lock`."""
        self.buf.load(scaled, thresh)
        _factor_sweep(self.sched, self.dtype, self.staged, self.buf,
                      self.fset)
        if self.pair:
            self.run(("decode_pair",), partial(decode_pair, self.lu))

    def solver(self, R: int, dtype: torch.dtype):
        """The handle's solve programs at nrhs R in `dtype` on the
        SLU_TRISOLVE arm (their runs are serialised by `lock`: the
        handle is the context's own)."""
        from . import trisolve
        arm = trisolve.trisolve_mode()
        key = (R, dtype, arm)
        if key not in self._solvers:
            self._solvers[key] = trisolve.solve_programs(
                self.lu, R, dtype, False, eager=self.eager, arm=arm)
        return self._solvers[key]

    def refinement(self, key, make):
        """The refinement state of `key`, made by `make()` at first
        use."""
        if key not in self._refinements:
            self._refinements[key] = make()
        return self._refinements[key]

    def run(self, key, body) -> None:
        """Run one refinement program: a graph of the context's own
        graph set on the card (captured at first use), eagerly
        otherwise."""
        if self.eager:
            body()
            return
        graphs.graph_set(self, "refine", self.device,
                         lambda: None).run(key, body)

    def graph_count(self) -> int:
        """Graphs this context's calls replay or have captured: the
        schedule's factor graphs, the handle's solve graphs and the
        refinement graphs."""
        return (graphs.graph_count(self.sched)
                + graphs.graph_count(self.lu) + graphs.graph_count(self))


_fused_lock = threading.Lock()


def fused_context(plan: FactorPlan, dtype, device, staged: bool,
                  eager: bool = False) -> FusedContext:
    """The plan's FusedContext for (factor dtype, storage, arm,
    device), made at first use and cached on its schedule; the storage
    is `_pair_mode(dtype)`."""
    sched = get_schedule(plan)
    pair = _pair_mode(dtype)
    key = (dtype_info(dtype).name, pair, bool(staged), str(device),
           bool(eager))
    with _fused_lock:
        cache = sched.__dict__.setdefault("_fused", {})
        if key not in cache:
            cache[key] = FusedContext(plan, dtype, device, staged, eager,
                                      pair)
        return cache[key]


def _to_device(a, device, what: str) -> torch.Tensor:
    """numpy or a tensor on `device` (a floating or complex dtype)."""
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a))).to(device)
    if not (t.is_complex() or t.is_floating_point()):
        raise TypeError(f"{what} must be floating point or complex, "
                        f"got {t.dtype}")
    return t


def _fused_inputs(plan: FactorPlan, vals, b, device, dtype) -> tuple:
    """A fused step's (vals, b) on `device`, checked against the plan
    and the factor dtype: vals (nnz,) in plan COO order, b (n, nrhs);
    complex values need a complex factor dtype."""
    v = _to_device(vals, device, "vals")
    bt = _to_device(b, device, "b")
    if v.is_complex() and not dtype_info(dtype).is_complex:
        raise TypeError(f"complex values with factor dtype "
                        f"{dtype_info(dtype).name}: pass a complex dtype")
    nnz, n = len(plan.coo_rows), plan.n
    if v.shape != (nnz,) or bt.ndim != 2 or bt.shape[0] != n:
        raise ValueError(f"vals {tuple(v.shape)} and b {tuple(bt.shape)}: "
                         f"expected ({nnz},) and ({n}, nrhs)")
    return v, bt


def _fused_device(plan: FactorPlan, device) -> torch.device:
    """The step's device: `device`, else the plan's (set by the entry
    point that planned it), resolved as the entry points resolve it."""
    return resolve_device(device if device is not None
                          else getattr(plan, "device", None))


def make_fused_step(plan: FactorPlan, dtype=np.float64, device=None,
                    eager: bool = False):
    """Build `step(vals, b) -> x`: the whole numeric phase — assemble,
    level-batched factorization, forward and backward sweeps — in one
    call (reference `ops/batched.py` make_fused_step).  `vals` are the
    scaled values in plan COO order and `b` the right-hand side in
    factor ordering, shape (n, nrhs), numpy or tensors; x comes back on
    the step's device in the promoted dtype of the factors and b (the
    solve promotes, it does not cast).  No zero-pivot check: as in the
    reference, a singular factor gives a non-finite x.  Under
    SLU_COMPLEX_PAIR=1 a complex `dtype` factors on pair storage."""
    dtype = dtype_info(dtype).handle
    dev = _fused_device(plan, device)
    ctx = fused_context(plan, dtype, dev, staged_enabled(get_schedule(plan)),
                        eager)
    thresh = _thresh_for(plan, dtype)

    def step(vals, b):
        v, bt = _fused_inputs(plan, vals, b, dev, dtype)
        sdt = solve_dtype(dtype, bt.dtype)
        with ctx.lock:
            ctx.factor(v, thresh)
            sp = ctx.solver(bt.shape[1], sdt)
            sp.bufs.load(bt)
            sp.run()
            return sp.bufs.X.clone()

    step.context = ctx
    return step


def _resid_berr(spmv, b: torch.Tensor, x: torch.Tensor):
    """(r, berr): the residual b − A·x and the componentwise backward
    error max_i |r_i| / (|A|·|x| + |b|)_i (a zero denominator counts as
    1), one scalar over every right-hand side, as a device tensor."""
    r = b - spmv.matvec(x)
    denom = spmv.absmatvec(x.abs()) + b.abs()
    denom = torch.where(denom == 0, 1, denom)
    return r, (r.abs() / denom).max()


class _Refinement:
    """The refinement loop's state for one (nrhs, refine dtype, layout,
    max_steps) of a FusedContext, as static tensors, and its two
    programs:

    * `start`: x = 0, r = b, berr = inf, steps = 0, and the first
      sweep's right-hand side;
    * `update`, after each solve: the correction d from the solve's X,
      x_new = x + d, the residual and berr of x_new through the device
      SpMV, the keep-the-better selects, the stop flag, the next
      sweep's right-hand side, and (stop, berr) into `flag`.

    The decisions are the reference's fused loop (ops/batched.py
    make_fused_solver `step_body`): the first iteration is the base
    solve and is kept whatever its berr; a later x is kept when berr
    drops; the loop stops when berr did not halve, or after
    max_steps + 1 iterations (the host also stops at berr ≤ eps).
    The sweeps run in the factors' working dtype (DTypeInfo.working:
    float32 for a bfloat16 factor)."""

    def __init__(self, ctx: FusedContext, R: int, rdt, layout: str,
                 max_steps: int, doubleword: bool = False):
        from .spmv import DeviceSpMV
        plan, dev = ctx.plan, ctx.device
        n = plan.n
        self.rdt = torch_dtype(rdt)
        self.sdt = dtype_info(ctx.dtype).working.torch
        real = self.rdt.to_real()        # berr is real on either lane
        self.max_steps = int(max_steps)
        self.sp = ctx.solver(R, self.sdt)
        self.spmv = DeviceSpMV.pattern(_plan_indptr(plan), plan.coo_cols,
                                       n, rdt, dev, layout=layout,
                                       doubleword=doubleword)
        inv_final_row = np.empty(n, dtype=np.int64)
        inv_final_row[plan.final_row] = np.arange(n)
        z = dict(dtype=self.rdt, device=dev)
        self.row_scale = torch.from_numpy(
            np.asarray(plan.row_scale)).to(dev, real)
        self.col_scale = torch.from_numpy(
            np.asarray(plan.col_scale)).to(dev, real)
        self.final_col = torch.from_numpy(
            np.asarray(plan.final_col, dtype=np.int64)).to(dev)
        self.inv_final_row = torch.from_numpy(inv_final_row).to(dev)
        self.b = torch.zeros((n, R), **z)
        self.x = torch.zeros((n, R), **z)
        self.r = torch.zeros((n, R), **z)
        self.berr = torch.zeros((), dtype=real, device=dev)
        self.steps = torch.zeros((), dtype=torch.int64, device=dev)
        # (stop, berr) for the host; float32 on the doubleword lane,
        # whose state holds no float64 tensor
        fl = torch.float32 if doubleword else torch.float64
        self.flag = torch.zeros(2, dtype=fl, device=dev)
        self.card = dev.type == "cuda"
        self.host = torch.zeros(2, dtype=fl, pin_memory=self.card)

    def _pre(self, r):
        """Original-order residual -> factor-order sweep right-hand
        side, cast to the sweep dtype (reference `_pre_impl`)."""
        return (r * self.row_scale[:, None]).index_select(
            0, self.inv_final_row).to(self.sdt)

    def _post(self, y):
        """Factor-order sweep output -> original-order correction in the
        refine dtype (reference `_post_impl`)."""
        return (y.index_select(0, self.final_col).to(self.rdt)
                * self.col_scale[:, None])

    def start(self) -> None:
        self.x.zero_()
        self.r.copy_(self.b)
        self._restart()

    def _restart(self) -> None:
        self.berr.fill_(float("inf"))
        self.steps.zero_()
        self.sp.bufs.B[:-1].copy_(self._pre(self.r))

    def _decide(self, berr_new):
        """(better, stop) of the reference's loop for the new berr."""
        first = self.steps == 0
        improved = berr_new < self.berr * 0.5
        better = first | (berr_new < self.berr)
        stop = ((~first & ~improved)
                | (self.steps + 1 >= self.max_steps + 1))
        return better, stop

    def _advance(self, better, berr_new, stop) -> None:
        """berr, the step count, the next sweep's right-hand side (from
        the kept residual) and the (stop, berr) flag."""
        self.berr.copy_(torch.where(better, berr_new, self.berr))
        self.steps += 1
        self.sp.bufs.B[:-1].copy_(self._pre(self.r))
        self.flag[0].copy_(stop)
        self.flag[1].copy_(self.berr)

    def update(self) -> None:
        x_new = self.x + self._post(self.sp.bufs.X)
        r_new, berr_new = _resid_berr(self.spmv, self.b, x_new)
        better, stop = self._decide(berr_new)
        self.x.copy_(torch.where(better, x_new, self.x))
        self.r.copy_(torch.where(better, r_new, self.r))
        self._advance(better, berr_new, stop)

    def read(self) -> tuple:
        """(stop, berr) of the last update, read on the host: the one
        host sync of an iteration."""
        if self.card:
            self.host.copy_(self.flag, non_blocking=True)
            torch.cuda.current_stream(self.flag.device).synchronize()
        else:
            self.host.copy_(self.flag)
        stop, berr = self.host.tolist()
        return bool(stop), berr


class _Df64Refinement(_Refinement):
    """The doubleword loop's state (reference make_fused_solver's
    doubleword `_core`): the solution as an fp32 (hi, lo) pair (x, xl),
    b as (b, bl), the operator's values as (hi, lo) planes, and r the
    fp32 residual hi + lo that the sweeps solve with.  Every floating
    tensor is float32.  `update`: x ← df_add_f(x, d), the df64 residual
    b − A·x through kernel K4 (ELL) or the COO lane, berr from its hi
    plane over |A|·|x_hi| + |b_hi| (the cancellation already happened
    in df64), then the plain loop's decisions; the host stops at
    DF64_EPS."""

    def __init__(self, ctx: FusedContext, R: int, layout: str,
                 max_steps: int):
        super().__init__(ctx, R, np.float32, layout, max_steps,
                         doubleword=True)
        self.bl = torch.zeros_like(self.b)
        self.xl = torch.zeros_like(self.x)

    def start(self) -> None:
        self.x.zero_()
        self.xl.zero_()
        torch.add(self.b, self.bl, out=self.r)
        self._restart()

    def resid_berr(self, xh, xl):
        """((r_hi, r_lo), berr) of the pair x."""
        from ..precision.doubleword import df_add
        axh, axl = self.spmv.matvec_df64(xh, xl)
        den = self.spmv.absmatvec(xh.abs())
        rh, rl = df_add((self.b, self.bl), (-axh, -axl))
        denom = den + self.b.abs()
        denom = torch.where(denom == 0, 1, denom)
        return (rh, rl), (rh.abs() / denom).max()

    def update(self) -> None:
        from ..precision.doubleword import df_add_f
        nh, nl = df_add_f((self.x, self.xl), self._post(self.sp.bufs.X))
        (rh, rl), berr_new = self.resid_berr(nh, nl)
        better, stop = self._decide(berr_new)
        self.x.copy_(torch.where(better, nh, self.x))
        self.xl.copy_(torch.where(better, nl, self.xl))
        self.r.copy_(torch.where(better, rh + rl, self.r))
        self._advance(better, berr_new, stop)


def _refine_loop(ctx: FusedContext, st: _Refinement, key,
                 eps: float) -> int:
    """The host loop over the refinement programs of `st` (its start
    program, then a solve and an update per iteration) until the update
    says stop or berr ≤ eps.  Returns the iterations run.  The caller
    holds `ctx.lock` and has loaded the factors and b."""
    ctx.run(("start",) + key, st.start)
    steps, berr, stop = 0, float("inf"), False
    while not stop and berr > eps:
        st.sp.run()
        ctx.run(("update",) + key, st.update)
        stop, berr = st.read()
        steps += 1
    return steps


def _loop_result(ctx: FusedContext, st: _Refinement, x, steps: int):
    """(x, berr, steps, tiny, nzero) of a fused solver call; `steps`
    counts loop iterations, the first of which is the base solve."""
    counts = ctx.buf.counts.to(torch.int32)
    return (x, st.berr.clone(),
            torch.tensor(max(steps - 1, 0), dtype=torch.int32,
                         device=st.berr.device),
            counts[0], counts[1])


def _plan_indptr(plan: FactorPlan) -> np.ndarray:
    """CSR row pointers of the plan's COO pattern (plan COO order is
    CSR row-major order)."""
    counts = np.bincount(np.asarray(plan.coo_rows), minlength=plan.n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def make_fused_solver(plan: FactorPlan, dtype=np.float32,
                      refine_dtype=None, max_steps: Optional[int] = None,
                      staged: Optional[bool] = None,
                      residual_mode: str = "auto", device=None,
                      eager: bool = False):
    """Build `step(vals, b) -> (x, berr, steps, tiny, nzero)`: the whole
    pdgssvx numeric pipeline on the device — scale, assemble,
    level-batched factorization in `dtype`, the sweeps, then iterative
    refinement with `refine_dtype` residual accumulation through the
    device SpMV (pdgsrfs + pdgsmv, SRC/pdgsrfs.c:124, SRC/pdgsmv.c; the
    mixed-precision strategy of psgssvx_d2, SRC/psgssvx_d2.c:516).  The
    reference's `make_fused_solver`, single device.

    `vals` are the unscaled values in plan COO order and `b` the
    right-hand side in the original ordering, shape (n, nrhs), numpy
    or tensors; the results are tensors on the step's device: x
    (refine dtype), berr (a scalar), steps (refinement steps after the
    base solve), and the tiny- and zero-pivot counts.  A zero pivot
    does not raise: it shows in `nzero` and a non-finite berr.

    `staged` None follows `staged_enabled`; both arms run the same way
    here (the staged arm's factor and solve programs per merged
    segment, the whole-phase arm's one factor program and one packed
    solve program).  On the card every program is a CUDA graph,
    captured at its first use; `eager=True` runs the same bodies
    eagerly there (the oracle of the card tests).  The residual mode,
    the refine dtype, the step budget and the SpMV layout resolve as
    the reference resolves them.  A complex `dtype` factors the complex
    system natively, or on pair storage under SLU_COMPLEX_PAIR=1, and
    refines in the complex dtype of the refine precision.

    residual_mode="doubleword" (a real factor coarser than float64, on
    the whole-phase arm; `_make_df64_step`): the values and b are split
    into exact fp32 (hi, lo) planes as they come in, the factor sweep
    reads vals_hi·s + vals_lo·s (s the float32 scale factors), the
    residual runs in df64 through kernel K4, the solution accumulates as
    an fp32 pair and is joined to float64 after the loop, which stops at
    DF64_EPS.  Nothing inside the loop's programs is float64.  A
    bfloat16 `dtype` factors in bfloat16 and sweeps in float32."""
    from ..options import IterRefine
    from ..precision.policy import resolve_residual_mode
    from . import trisolve
    from .spmv import doubleword_layout, ell_from_csr, spmv_layout
    info = dtype_info(dtype)
    dtype = info.handle
    sched = get_schedule(plan)
    # ---- the residual mode (precision/policy.py), resolved as the
    # reference resolves it ----
    mode = (residual_mode if residual_mode != "auto"
            else resolve_residual_mode(plan.options))
    if mode not in ("plain", "doubleword", "fp64"):
        raise ValueError(f"unknown residual_mode {mode!r}; expected "
                         "auto|plain|doubleword|fp64")
    if mode == "doubleword" and (info.is_complex or info.itemsize >= 8):
        # an f64 factor gains nothing from fp32 pairs, and complex
        # systems accumulate natively
        if residual_mode == "doubleword":
            raise ValueError(
                "residual_mode='doubleword' is the single-device real "
                "fused path for low-precision factors (df64 fp32 "
                "pairs); complex systems and f64-class factors "
                "accumulate natively — use residual_mode='fp64' there")
        mode = "fp64"
    if mode == "doubleword":
        if staged:
            if residual_mode == "doubleword":
                raise ValueError(
                    "residual_mode='doubleword' requires the fused "
                    "one-program formulation; pass staged=False")
            mode = "fp64"
        elif staged is None and staged_enabled(sched):
            if residual_mode == "doubleword":
                staged = False
            else:
                mode = "fp64"
    if refine_dtype is None:
        refine_dtype = (dtype if mode == "plain"
                        else plan.options.refine_dtype)
    if mode == "doubleword":
        # the df64 pairs are the accumulator: every operand below is
        # the float32 hi-plane dtype, the target DF64_EPS
        refine_dtype = np.float32
    # a plain residual of a bfloat16 factor accumulates in its sweep
    # dtype (float32: numpy has no bfloat16)
    rdt = dtype_info(refine_dtype).working.numpy
    if info.is_complex and rdt.kind != "c":
        # complex system: the accumulator keeps its precision but is
        # complex (models/refine._refine_dtype)
        rdt = np.promote_types(rdt, np.complex64)
    if max_steps is None:
        max_steps = (0 if plan.options.iter_refine == IterRefine.NOREFINE
                     else int(plan.options.max_refine_steps))
    if staged is None:
        staged = staged_enabled(sched)
    dev = _fused_device(plan, device)
    ctx = fused_context(plan, dtype, dev, staged, eager)
    thresh = _thresh_for(plan, dtype)
    eps = float(np.finfo(rdt).eps)
    n, nnz = plan.n, len(plan.coo_rows)
    # ---- the residual SpMV's layout: padded ELL unless its padding
    # exceeds the waste limit (ops/spmv.py) ----
    _, ell_w = ell_from_csr(_plan_indptr(plan), plan.coo_cols, nnz=nnz)
    layout = spmv_layout(nnz, n, ell_w)
    if mode == "doubleword":
        layout = doubleword_layout(layout)
        return _make_df64_step(plan, ctx, dtype, thresh, layout,
                               max_steps, dev)
    scale_fac = torch.from_numpy(np.asarray(
        plan.row_scale[plan.coo_rows] * plan.col_scale[plan.coo_cols],
        dtype=np.float64)).to(dev)

    def step(vals, b):
        v, bt = _fused_inputs(plan, vals, b, dev, dtype)
        R = bt.shape[1]
        # the solve arm is read per call, as the reference's staged
        # step reads it; it keys the refinement state, whose solve
        # programs are the arm's
        key = (R, rdt.str, layout, max_steps, trisolve.trisolve_mode())
        with ctx.lock:
            st = ctx.refinement(key, lambda: _Refinement(
                ctx, R, rdt, layout, max_steps))
            ctx.factor(v * scale_fac, thresh)
            st.spmv.load(v)
            st.b.copy_(bt)
            steps = _refine_loop(ctx, st, key, eps)
            return _loop_result(ctx, st, st.x.clone(), steps)

    def resid_fn(vals, b, x):
        """The refinement residual and berr exactly as the loop computes
        them: (r, berr) of x for the unscaled `vals` and b (original
        ordering, cast to the refine dtype)."""
        from .spmv import DeviceSpMV
        v, bt = _fused_inputs(plan, vals, b, dev, dtype)
        op = DeviceSpMV.pattern(_plan_indptr(plan), plan.coo_cols, n, rdt,
                                dev, layout=layout)
        op.load(v)
        tr = torch_dtype(rdt)
        return _resid_berr(op, bt.to(tr), _to_device(x, dev, "x").to(tr))

    step.resid_fn = resid_fn
    step.spmv_layout = layout
    step.residual_mode = mode
    step.context = ctx
    return step


def _make_df64_step(plan: FactorPlan, ctx: FusedContext, dtype,
                    thresh: float, layout: str, max_steps: int,
                    dev: torch.device):
    """make_fused_solver's doubleword lane (reference `_core` and its
    `step`): same contract, x joined to float64 after the loop."""
    from ..precision.doubleword import (DF64_EPS, join_f64_tensor,
                                        split_f64_tensor)
    from . import trisolve
    scale32 = torch.from_numpy(np.asarray(
        plan.row_scale[plan.coo_rows] * plan.col_scale[plan.coo_cols],
        dtype=np.float32)).to(dev)

    def step(vals, b):
        v, bt = _fused_inputs(plan, vals, b, dev, dtype)
        R = bt.shape[1]
        key = (R, "df64", layout, max_steps, trisolve.trisolve_mode())
        # the exact fp32 split of the float64 inputs, outside the loop's
        # programs
        vh, vl = split_f64_tensor(v)
        bh, bl = split_f64_tensor(bt)
        with ctx.lock:
            st = ctx.refinement(key, lambda: _Df64Refinement(
                ctx, R, layout, max_steps))
            # both planes contribute to the scaled factor values: one
            # fp32 rounding instead of the two a hi-only product pays
            ctx.factor(vh * scale32 + vl * scale32, thresh)
            st.spmv.load(vh, vl)
            st.b.copy_(bh)
            st.bl.copy_(bl)
            steps = _refine_loop(ctx, st, key, DF64_EPS)
            return _loop_result(ctx, st, join_f64_tensor(st.x, st.xl),
                                steps)

    step.spmv_layout = layout
    step.residual_mode = "doubleword"
    step.context = ctx
    return step
