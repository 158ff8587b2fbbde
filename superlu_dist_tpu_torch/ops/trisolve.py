"""Blocked triangular solve in the lsum layout.

The solve path rebuilt around the reference's lsum/fmod dataflow
(SRC/pdgstrs_lsum.c, dlsum_fmod_inv_gpu_mrhs in
SRC/pdgstrs_lsum_cuda.cu), re-expressed for the batched static
schedule:

  * packed solve panels — Li / L21 / Ui / U12 are views into the
    factor panels, dead padded lanes dropped, built once per
    factorization and cached on the handle;
  * lsum gather/update layout — off-diagonal updates are written
    densely into a flat lsum buffer UPD and consumers subtract their
    contributions through a precomputed gather, one J-step chain that
    replays the reference's application order.

The forward step of each non-transposed group with update rows runs
kernel K3 (ops/lsum.py); the transposed lane and the backward sweep
are PyTorch batched products.  `build_trisolve` is the reference's at
one device, and its index arrays and merged segments equal the
reference's (tests/test_torch_schedule.py, tests/test_torch_staged.py).

The sweeps run as the reference's compiled programs do: a StagedLU
through one program per merged forward segment and one per backward
segment (`staged_sweeps`), a DeviceLU through one packed program for
the whole solve (`solve_packed`).  On the card a program is a CUDA
graph (ops/graphs.py) owned by the factor handle, since it reads that
handle's panels, and keyed by (nrhs, trans, rhs dtype); on the CPU the
same bodies run eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
from functools import partial
from typing import List

import numpy as np
import torch

from .. import flags
from ..device import upload_int64
from . import graphs
from .lsum import lsum_panel


def merge_cells_limit() -> int:
    """A group whose panel-cell count (trim · mb · wb) is at or below
    this joins a merged segment (SLU_TRISOLVE_MERGE_CELLS, default
    65536); larger groups stand alone."""
    try:
        return max(0, flags.env_int("SLU_TRISOLVE_MERGE_CELLS", 65536))
    except ValueError:
        return 65536


def seg_cells_limit() -> int:
    """Total panel-cell budget of one merged segment
    (SLU_TRISOLVE_SEG_CELLS, default 1048576)."""
    try:
        return max(1, flags.env_int("SLU_TRISOLVE_SEG_CELLS", 1048576))
    except ValueError:
        return 1048576


@dataclasses.dataclass
class GroupSolve:
    """One factor group's solve-time layout.  `trim` is the batch
    actually used (the dummy fronts of the padded batch dropped)."""
    gi: int                 # index into sched.groups
    trim: int
    rtrim: int              # forward update-row extent (the full rb)
    J: int                  # contributor-gather chain depth
    y_off: int              # this group's slot base in Y/XF
    u_off: int              # this group's slot base in UPD
    b_idx: np.ndarray       # (trim, wb) rows of B, pad -> n
    u_gidx: np.ndarray      # (J, trim, wb) UPD slots, pad -> u_total
    xs_idx: np.ndarray      # (trim, rb) XF slots, pad -> y_total


@dataclasses.dataclass
class TrisolveSchedule:
    """The precomputed lsum layout for one BatchedSchedule: dense slot
    spaces for the forward outputs (Y, reused by the backward sweep's
    XF) and the off-diagonal update buffer (UPD), per-group
    contributor gathers, and the merged segments."""
    sched: object                    # ops.batched.BatchedSchedule
    groups: List[GroupSolve]         # parallel to sched.groups
    segments: List[List[int]]        # group indices per segment
    y_total: int                     # Y/XF slots (+1 sentinel)
    u_total: int                     # UPD slots (+1 sentinel)
    final_idx: np.ndarray            # (n,) row -> XF slot
    _dev: dict = dataclasses.field(default=None, repr=False)

    def dev(self, device):
        """([(b_idx, u_gidx, xs_idx) per group], final_idx) as int64
        tensors on `device`, uploaded in one copy and cached."""
        if self._dev is None:
            self._dev = {}
        key = str(torch.device(device))
        if key not in self._dev:
            arrays = [a for gs in self.groups
                      for a in (gs.b_idx, gs.u_gidx, gs.xs_idx)]
            ts = upload_int64(arrays + [self.final_idx], device)
            idxs = [tuple(ts[3 * i:3 * i + 3])
                    for i in range(len(self.groups))]
            self._dev[key] = (idxs, ts[-1])
        return self._dev[key]


def build_trisolve(sched) -> TrisolveSchedule:
    """The lsum layout of a BatchedSchedule.  The contributor-subtract
    chain replays the reference's application order: groups in
    program order; within a group, the update tensor's row-major
    order."""
    n = sched.n
    groups = sched.groups

    y_total = u_total = 0
    metas = []
    for g in groups:
        # lanes are packed [0, n_true) by construction
        trim = max(1, min(g.n_true, g.n_loc))
        rb = g.mb - g.wb
        rt = rb
        metas.append((trim, rb, rt, y_total, u_total))
        y_total += trim * g.wb
        u_total += trim * rt

    # production side: every struct-row update's (row, UPD slot) pair
    # in application order
    prod_rows, prod_slots = [], []
    for g, (trim, rb, rt, y_off, u_off) in zip(groups, metas):
        if rt == 0:
            continue
        si = np.asarray(g.struct_idx)[:trim, :rt]          # (t, rt)
        base = (u_off + np.arange(trim)[:, None] * rt
                + np.arange(rt)[None, :])
        keep = si < n
        prod_rows.append(si[keep].ravel())
        prod_slots.append(base[keep].ravel())
    if prod_rows:
        prod_rows = np.concatenate(prod_rows)
        prod_slots = np.concatenate(prod_slots)
    else:
        prod_rows = np.zeros(0, np.int64)
        prod_slots = np.zeros(0, np.int64)

    # per-row contribution table in arrival order: slot_table[r, j] is
    # the j-th contribution's UPD slot (sentinel u_total otherwise)
    counts = np.bincount(prod_rows, minlength=n)
    Jmax = int(counts.max()) if counts.size else 0
    order = np.argsort(prod_rows, kind="stable")
    sorted_rows = prod_rows[order]
    first = np.searchsorted(sorted_rows, np.arange(n))
    rank = np.arange(len(sorted_rows)) - first[sorted_rows]
    slot_table = np.full((n + 1, max(Jmax, 1)), u_total, dtype=np.int64)
    slot_table[sorted_rows, rank] = prod_slots[order]

    gsolves: List[GroupSolve] = []
    slot_of = np.full(n + 1, y_total, dtype=np.int64)
    for gi, (g, (trim, rb, rt, y_off, u_off)) in enumerate(
            zip(groups, metas)):
        ci = np.asarray(g.col_idx)[:trim, :]                # (t, wb)
        live = ci[ci < n]
        J = int(counts[live].max()) if live.size else 0
        if J > 0:
            u_gidx = np.moveaxis(slot_table[np.minimum(ci, n), :J], -1, 0)
        else:
            u_gidx = np.zeros((0, trim, g.wb), dtype=np.int64)
        ybase = (y_off + np.arange(trim)[:, None] * g.wb
                 + np.arange(g.wb)[None, :])
        keep = ci < n
        slot_of[ci[keep]] = ybase[keep]
        gsolves.append(GroupSolve(
            gi=gi, trim=trim, rtrim=rt, J=J, y_off=y_off, u_off=u_off,
            b_idx=ci.astype(np.int64),
            u_gidx=np.ascontiguousarray(u_gidx, dtype=np.int64),
            xs_idx=np.zeros((trim, rb), dtype=np.int64)))

    # backward consumption: struct rows -> owner XF slots
    for g, gs in zip(groups, gsolves):
        si = np.asarray(g.struct_idx)[:gs.trim, :]
        gs.xs_idx = slot_of[np.minimum(si, n)].astype(np.int64)
    final_idx = slot_of[:n].astype(np.int64)

    # merged segments (the single-device branch of the reference's
    # level-merge pass): chains of small consecutive groups fold into
    # one program
    cells = merge_cells_limit()
    seg_cap = seg_cells_limit()
    segments: List[List[int]] = []
    cur: List[int] = []
    cur_cells = 0
    for g, gs in zip(groups, gsolves):
        c = gs.trim * g.mb * g.wb
        small = c <= cells
        if cur and ((not small) or cur_cells + c > seg_cap):
            segments.append(cur)
            cur, cur_cells = [], 0
        cur.append(gs.gi)
        cur_cells += c
        if not small:
            segments.append(cur)
            cur, cur_cells = [], 0
    if cur:
        segments.append(cur)

    return TrisolveSchedule(sched=sched, groups=gsolves,
                            segments=segments, y_total=y_total,
                            u_total=u_total, final_idx=final_idx)


def _limits_key() -> tuple:
    return (merge_cells_limit(), seg_cells_limit())


def get_trisolve(sched) -> TrisolveSchedule:
    """The schedule's lsum layout, cached on it per segmenting knobs (a
    flag change mid-process takes effect)."""
    cache = sched.__dict__.setdefault("_trisolve", {})
    key = _limits_key()
    if key not in cache:
        cache[key] = build_trisolve(sched)
    return cache[key]


def _pack(g, t: int, L, U, Li, Ui) -> tuple:
    """(Li, L21, Ui, U12) of one group's panels, dead lanes dropped: no
    copies, L21 and U12 are strided views."""
    wb, mb = g.wb, g.mb
    Lp = L.view(g.n_loc, mb, wb)
    Up = U.view(g.n_loc, wb, mb)
    return (Li.view(g.n_loc, wb, wb)[:t], Lp[:t, wb:, :],
            Ui.view(g.n_loc, wb, wb)[:t], Up[:t, :, wb:])


def pack_panels(ts: TrisolveSchedule, flats) -> list:
    """Per-group packed panels sliced out of the four DeviceLU slabs at
    the groups' offsets."""
    from .batched import _group_views
    return pack_panels_staged(ts, _group_views(ts.sched, flats))


def pack_panels_staged(ts: TrisolveSchedule, panels) -> list:
    """pack_panels over StagedLU's per-group local flats."""
    return [_pack(g, gs.trim, *p)
            for g, gs, p in zip(ts.sched.groups, ts.groups, panels)]


def get_packs(lu) -> list:
    """Per-handle packed panels (a StagedLU's or a DeviceLU's), built
    once per factorization on the first solve and cached on the
    handle."""
    packs = lu.__dict__.get("_packs")
    if packs is None:
        from .batched import StagedLU
        ts = get_trisolve(lu.schedule)
        packs = lu.__dict__["_packs"] = (
            pack_panels_staged(ts, lu.panels) if isinstance(lu, StagedLU)
            else pack_panels(ts, lu.flats()))
    return packs


def chain_subtract(xb: torch.Tensor, UPD: torch.Tensor,
                   u_gidx: torch.Tensor, J: int) -> torch.Tensor:
    """The contributor-subtract chain: one gather of all J planes,
    then the sequential fold.  The subtraction order replays the
    reference's application order."""
    if J <= 0:
        return xb
    xg = UPD[u_gidx]                                # (J, t, wb, R)
    for j in range(J):
        xb = xb - xg[j]
    return xb


class SolveBuffers:
    """The dense buffers of one sweep, in the solve dtype: B (the
    right-hand side with a zero sentinel row appended), UPD, Y and XF
    (zero-initialised, each with its zero sentinel slot, the gathers'
    padding target; every other slot is written before it is read) and
    the solution X.  A captured solve keeps one set as its static
    tensors (the sentinels are never written, so they stay zero); an
    eager solve makes a fresh one.  The reference's
    `init_lsum_buffers`."""

    def __init__(self, ts: TrisolveSchedule, R: int, dtype, device):
        z = dict(dtype=dtype, device=device)
        n = ts.sched.n
        self.B = torch.zeros((n + 1, R), **z)
        self.UPD = torch.zeros((ts.u_total + 1, R), **z)
        self.Y = torch.zeros((ts.y_total + 1, R), **z)
        self.XF = torch.zeros((ts.y_total + 1, R), **z)
        self.X = torch.empty((n, R), **z)

    def load(self, b: torch.Tensor) -> None:
        self.B[:-1].copy_(b)


def _fwd_member(state, g, gs, pack, idx, trans: bool):
    """One group's forward lsum step on the dense buffers: xb = B[cols]
    minus the contributor chain, the panel solve, then the
    off-diagonal update written densely.  `trans` swaps the L panels
    for the Uᵀ pair over the same layout (Mᵀ = Uᵀ·Lᵀ).  The
    non-transposed lane runs kernel K3 (a group without update rows
    computes y alone)."""
    B, UPD, Y = state
    b_idx, u_gidx, _ = idx
    xb = chain_subtract(B[b_idx], UPD, u_gidx, gs.J)
    R = xb.shape[-1]
    if not trans:
        Li_p, L21_p, _, _ = pack
        lsum_panel(Li_p, L21_p, xb.contiguous(), Y, UPD, gs.y_off,
                   gs.u_off, gs.rtrim)
        return B, UPD, Y
    dt = xb.dtype
    _, _, Ui_p, U12_p = pack
    y = torch.bmm(Ui_p.to(dt).transpose(1, 2), xb)          # Uiᵀ·xb
    Y[gs.y_off:gs.y_off + y.shape[0] * y.shape[1]] = y.reshape(-1, R)
    if gs.rtrim > 0:
        rt = gs.rtrim
        upd = torch.bmm(U12_p[:, :, :rt].to(dt).transpose(1, 2), y)
        UPD[gs.u_off:gs.u_off + upd.shape[0] * rt] = upd.reshape(-1, R)
    return B, UPD, Y


def _bwd_member(XF, Y, g, gs, pack, idx, trans: bool):
    """One group's backward step: xb from this group's own dense Y
    block, ancestor rows gathered from XF slots, the solution written
    densely back to the same slot base."""
    _, _, xs_idx = idx
    R = Y.shape[-1]
    dt = Y.dtype
    n_rows = gs.trim * g.wb
    xb = Y[gs.y_off:gs.y_off + n_rows].view(gs.trim, g.wb, R)
    if trans:
        Li_p, L21_p, _, _ = pack
        if g.mb > g.wb:
            xs = XF[xs_idx]
            xb = xb - torch.bmm(L21_p.to(dt).transpose(1, 2), xs)
        x1 = torch.bmm(Li_p.to(dt).transpose(1, 2), xb)     # Liᵀ·rhs
    else:
        _, _, Ui_p, U12_p = pack
        if g.mb > g.wb:
            xs = XF[xs_idx]
            xb = xb - torch.bmm(U12_p.to(dt), xs)
        x1 = torch.bmm(Ui_p.to(dt), xb)
    XF[gs.y_off:gs.y_off + n_rows] = x1.reshape(-1, R)
    return XF


def seg_metas(ts: TrisolveSchedule, members, cplx: bool = False) -> tuple:
    """The static meta tuple of one solve segment's members, in the
    given order: (wb, mb, trim, rtrim, J, y_off, u_off, cplx) each (the
    reference's segment jit key; here part of a segment graph's key)."""
    sched = ts.sched
    return tuple(
        (sched.groups[i].wb, sched.groups[i].mb, ts.groups[i].trim,
         ts.groups[i].rtrim, ts.groups[i].J, ts.groups[i].y_off,
         ts.groups[i].u_off, cplx)
        for i in members)


def _staged_fwd_segment(ts, packs, idxs, members, bufs: SolveBuffers,
                        trans: bool) -> None:
    """One forward segment: its members' forward steps in order, UPD
    and Y updated in place."""
    state = (bufs.B, bufs.UPD, bufs.Y)
    for i in members:
        _fwd_member(state, ts.sched.groups[i], ts.groups[i], packs[i],
                    idxs[i], trans)


def _staged_bwd_segment(ts, packs, idxs, members, bufs: SolveBuffers,
                        trans: bool) -> None:
    """One backward segment: its members' backward steps in reverse
    order, XF updated in place."""
    for i in reversed(members):
        _bwd_member(bufs.XF, bufs.Y, ts.sched.groups[i], ts.groups[i],
                    packs[i], idxs[i], trans)


def _final_gather(bufs: SolveBuffers, fin: torch.Tensor) -> None:
    torch.index_select(bufs.XF, 0, fin, out=bufs.X)


def _staged_programs(trans: bool):
    """The staged solve's program list: one program per merged forward
    segment, one per backward segment (in reverse), and the final
    gather."""
    def programs(ts, packs, idxs, fin):
        fwd = [(("fwd", tuple(seg), seg_metas(ts, seg)),
                partial(_staged_fwd_segment, ts, packs, idxs, seg,
                        trans=trans))
               for seg in ts.segments]
        bwd = [(("bwd", tuple(seg), seg_metas(ts, seg[::-1])),
                partial(_staged_bwd_segment, ts, packs, idxs, seg,
                        trans=trans))
               for seg in reversed(ts.segments)]
        return fwd + bwd + [(("gather",), partial(_final_gather, fin=fin))]
    return programs


class SolvePrograms:
    """One handle's solve at one (nrhs, trans, rhs dtype): the programs
    that `programs(ts, packs, idxs, fin)` lists — [(key, body(bufs))],
    in order — on one set of SolveBuffers.  The caller fills
    `bufs.B[:-1]`, calls `run()` and reads `bufs.X`.  On the card the
    programs are the handle's graphs for that key (captured at first
    use; the buffers are their static tensors, and the caller holds
    `lock` from filling B to reading X); on the CPU, or with `eager`,
    they run eagerly on buffers of this object's own."""

    def __init__(self, lu, R: int, dtype, trans: bool, programs,
                 eager: bool = False):
        ts = get_trisolve(lu.schedule)
        packs = get_packs(lu)
        device = lu.device
        idxs, fin = ts.dev(device)       # uploaded before any capture
        self.progs = programs(ts, packs, idxs, fin)
        if eager or not graphs.on_card(device):
            self.gset = None
            self.bufs = SolveBuffers(ts, R, dtype, device)
            self.lock = threading.Lock()
        else:
            self.gset = graphs.graph_set(
                lu, (R, bool(trans), str(dtype), _limits_key()), device,
                lambda: SolveBuffers(ts, R, dtype, device))
            self.bufs = self.gset.static
            self.lock = self.gset.lock

    def run(self) -> None:
        for key, body in self.progs:
            if self.gset is None:
                body(self.bufs)
            else:
                self.gset.run(key, lambda body=body: body(self.bufs))


def solve_programs(lu, R: int, dtype, trans: bool = False,
                   eager: bool = False) -> SolvePrograms:
    """The solve programs of a handle as the reference routes them: a
    StagedLU through the staged segment sweeps, any other handle
    through the packed solve."""
    from .batched import StagedLU
    programs = (_staged_programs(trans) if isinstance(lu, StagedLU)
                else _solve_packed_fn(trans))
    return SolvePrograms(lu, R, dtype, trans, programs, eager)


def _run_solve(lu, b: torch.Tensor, trans: bool, eager: bool,
               programs) -> torch.Tensor:
    """Solve with b (n, nrhs, in the solve dtype) through `programs`
    (see SolvePrograms).  Returns the solution, the caller's own."""
    sp = SolvePrograms(lu, b.shape[-1], b.dtype, trans, programs, eager)
    with sp.lock:
        sp.bufs.load(b)
        sp.run()
        return sp.bufs.X if sp.gset is None else sp.bufs.X.clone()


def staged_sweeps(lu, b: torch.Tensor, trans: bool,
                  eager: bool = False) -> torch.Tensor:
    """The staged solve of a StagedLU: one program per merged forward
    segment, one per backward segment (in reverse), and the final
    gather.  b (n, nrhs) in factor ordering and the solve dtype."""
    return _run_solve(lu, b, trans, eager, _staged_programs(trans))


def sweep(ts: TrisolveSchedule, packs, idxs, fin, trans: bool,
          bufs: SolveBuffers) -> None:
    """The whole merged triangular solve on the buffers: every forward
    step, every backward step, the final gather into bufs.X."""
    every = list(range(len(ts.groups)))
    _staged_fwd_segment(ts, packs, idxs, every, bufs, trans)
    _staged_bwd_segment(ts, packs, idxs, every, bufs, trans)
    _final_gather(bufs, fin)


def _solve_packed_fn(trans: bool):
    """The packed solve's program list for `_run_solve`: the whole
    sweep as one program.  The reference caches its jitted program per
    (schedule, dtype); here the program's graphs read one handle's
    panels, so `_run_solve` keeps them on the handle per (nrhs, trans,
    rhs dtype)."""
    return lambda *ctx: [(("packed",), partial(sweep, *ctx, trans))]


def solve_packed(lu, b: torch.Tensor, trans: bool,
                 eager: bool = False) -> torch.Tensor:
    """The packed solve of a DeviceLU (or any handle): the whole sweep
    as one program over the handle's packed panels.  b (n, nrhs) in
    factor ordering and the solve dtype."""
    return _run_solve(lu, b, trans, eager, _solve_packed_fn(trans))
