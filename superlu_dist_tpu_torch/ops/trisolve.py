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
one device, and its index arrays equal the reference's
(tests/test_torch_schedule.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..device import upload_int64
from .lsum import lsum_panel


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
    XF) and the off-diagonal update buffer (UPD), and per-group
    contributor gathers."""
    sched: object                    # ops.batched.BatchedSchedule
    groups: List[GroupSolve]         # parallel to sched.groups
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

    return TrisolveSchedule(sched=sched, groups=gsolves,
                            y_total=y_total,
                            u_total=u_total, final_idx=final_idx)


def get_trisolve(sched) -> TrisolveSchedule:
    """The schedule's lsum layout, built once and cached on it."""
    if "_trisolve" not in sched.__dict__:
        sched._trisolve = build_trisolve(sched)
    return sched._trisolve


def pack_panels_staged(ts: TrisolveSchedule, panels):
    """Per-group (Li, L21, Ui, U12) views into the factor panels
    (group-local flats), dead lanes dropped.  No copies: L21 and U12
    are strided views."""
    sched = ts.sched
    packs = []
    for g, gs, p in zip(sched.groups, ts.groups, panels):
        t, wb, mb = gs.trim, g.wb, g.mb
        L, U, Li, Ui = p
        Lp = L.view(g.n_loc, mb, wb)
        Up = U.view(g.n_loc, wb, mb)
        packs.append((Li.view(g.n_loc, wb, wb)[:t],
                      Lp[:t, wb:, :],
                      Ui.view(g.n_loc, wb, wb)[:t],
                      Up[:t, :, wb:]))
    return packs


def get_packs(lu):
    """Per-handle packed panels, built once per factorization on the
    first solve and cached on the handle."""
    if lu._packs is None:
        lu._packs = pack_panels_staged(get_trisolve(lu.schedule),
                                       lu.panels)
    return lu._packs


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


def init_lsum_buffers(ts: TrisolveSchedule, B0: torch.Tensor):
    """(B, UPD, Y) dense buffers for one sweep: B is the right-hand
    side with a zero sentinel row appended, UPD/Y zero-initialized
    with their zero sentinel slots (the gathers' padding targets)."""
    R = B0.shape[-1]
    z = dict(dtype=B0.dtype, device=B0.device)
    B = torch.cat([B0, torch.zeros((1, R), **z)])
    UPD = torch.zeros((ts.u_total + 1, R), **z)
    Y = torch.zeros((ts.y_total + 1, R), **z)
    return B, UPD, Y


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


def sweep(ts: TrisolveSchedule, packs, b: torch.Tensor,
          trans: bool) -> torch.Tensor:
    """The full merged triangular solve: b (n, nrhs) in factor
    ordering, on the factors' device, in the solve dtype -> x."""
    sched = ts.sched
    B, UPD, Y = init_lsum_buffers(ts, b)
    R = b.shape[-1]
    device = b.device
    idxs, fin = ts.dev(device)
    state = (B, UPD, Y)
    for g, gs, pack, idx in zip(sched.groups, ts.groups, packs, idxs):
        state = _fwd_member(state, g, gs, pack, idx, trans)
    _, _, Y = state
    XF = torch.zeros((ts.y_total + 1, R), dtype=b.dtype, device=device)
    for g, gs, pack, idx in zip(reversed(sched.groups),
                                reversed(ts.groups), reversed(packs),
                                reversed(idxs)):
        XF = _bwd_member(XF, Y, g, gs, pack, idx, trans)
    return XF[fin]
