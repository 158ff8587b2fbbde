"""Dense front operations as PyTorch functions.

`partial_lu_batch` is the blocked right-looking partial LU without
pivoting of a batch of fronts — the analog of pdgstrf2_trsm /
Local_Dgstrf2 (SRC/pdgstrf2.c:26-98,404) fused with the U-row TRSM and
the leading Schur update:

    for each nb-wide column block:
        rank-1 factorization of the nb×nb diagonal block (tiny-pivot
        replacement, the GESP sqrt(eps)·‖A‖ rule of SRC/pdgstrf2.c)
        L21 = A21·U11⁻¹ and U12 = L11⁻¹·A12 (Newton triangular inverses)
        trailing update F22 −= L21·U12

It is the plain version of kernel K1 (ops/panel_lu.py) and what the CPU
path runs.  The triangular inverses (`unit_lower_inverse`,
`upper_inverse`) prepare the diagonal blocks for the GEMM-form solve
(DiagInv=YES, SRC/pdgssvx.c:1436-1447) on every device.  The Newton
iteration is kept as the reference wrote it, so the two packages agree
to rounding; whether a triangular solve replaces it is a later
question for the card.
"""

from __future__ import annotations

import torch


def _newton_tri_inverse(T: torch.Tensor, *, lower: bool,
                        unit: bool) -> torch.Tensor:
    """inv(T) for batched (…, k, k) triangular T via Newton iteration
    X ← X(2I − TX).  The error I − TX is nilpotent for triangular T
    (strictly triangular after the diagonal seed), so the iteration is
    exact after ⌈log2 k⌉ steps."""
    k = T.shape[-1]
    eye = torch.eye(k, dtype=T.dtype, device=T.device)
    keep = (torch.tril(torch.ones(k, k, dtype=torch.bool,
                                  device=T.device), -1) if lower else
            torch.triu(torch.ones(k, k, dtype=torch.bool,
                                  device=T.device), 1))
    N = torch.where(keep, T, torch.zeros((), dtype=T.dtype,
                                         device=T.device))
    if unit:
        X = eye - N
        A = eye + N
    else:
        d = torch.diagonal(T, dim1=-2, dim2=-1).unsqueeze(-1)
        # D⁻¹T = I + D⁻¹N for both lower and upper: scale N's rows
        Nn = N / d
        X = eye - Nn
        A = eye + Nn
    steps = max(0, (k - 1).bit_length() - 1)
    for _ in range(steps):
        X = X @ (2 * eye - A @ X)
    if not unit:
        X = X / d.transpose(-1, -2)        # inv = inv(I+D⁻¹N)·D⁻¹
    return X


def _blocked_tri_inverse(T: torch.Tensor, *, lower: bool, unit: bool,
                         base: int = 64) -> torch.Tensor:
    """inv(T) for batched (…, k, k) triangular T by 2×2 block
    recursion: inv([[A,0],[C,B]]) = [[Ai,0],[−Bi·C·Ai,Bi]] (lower) and
    the transposed identity for upper; leaves use the Newton
    inverse.

    When every halving is exact (k = s·2^d, s ≤ base) the recursion
    runs level by level instead: all 2^d leaves are inverted in one
    batched Newton call and each level's block pairs are combined in
    one batched step — the same operations on the same blocks, in
    tens of launches instead of hundreds."""
    k = T.shape[-1]
    if k <= base:
        return _newton_tri_inverse(T, lower=lower, unit=unit)
    s, d = k, 0
    while s > base and s % 2 == 0:
        s, d = s // 2, d + 1
    if s <= base:
        return _level_tri_inverse(T, s, d, lower=lower, unit=unit)
    h = k // 2
    A = T[..., :h, :h]
    B = T[..., h:, h:]
    Ai = _blocked_tri_inverse(A, lower=lower, unit=unit, base=base)
    Bi = _blocked_tri_inverse(B, lower=lower, unit=unit, base=base)
    if lower:
        C = T[..., h:, :h]
        off = -(Bi @ C @ Ai)
        top = torch.cat([Ai, torch.zeros_like(C.transpose(-1, -2))],
                        dim=-1)
        bot = torch.cat([off, Bi], dim=-1)
    else:
        C = T[..., :h, h:]
        off = -(Ai @ C @ Bi)
        top = torch.cat([Ai, off], dim=-1)
        bot = torch.cat([torch.zeros_like(C.transpose(-1, -2)), Bi],
                        dim=-1)
    return torch.cat([top, bot], dim=-2)


def _level_tri_inverse(T: torch.Tensor, s: int, d: int, *, lower: bool,
                       unit: bool) -> torch.Tensor:
    """_blocked_tri_inverse for k = s·2^d, one tree level at a time."""
    lead = T.shape[:-2]
    nblk = 1 << d
    T4 = T.reshape(*lead, nblk, s, nblk, s)
    leaves = torch.diagonal(T4, dim1=-4, dim2=-2).movedim(-1, -3)
    X = _newton_tri_inverse(leaves, lower=lower, unit=unit)
    b = s
    while X.shape[-3] > 1:
        nb = X.shape[-3]
        Ai, Bi = X[..., 0::2, :, :], X[..., 1::2, :, :]
        T4 = T.reshape(*lead, nb, b, nb, b)
        # the off-diagonal block of each pair: (2j+1, 2j) lower,
        # (2j, 2j+1) upper
        C = torch.diagonal(T4, offset=-1 if lower else 1, dim1=-4,
                           dim2=-2)[..., 0::2].movedim(-1, -3)
        Z = torch.zeros_like(Ai)
        if lower:
            off = -(Bi @ C @ Ai)
            top = torch.cat([Ai, Z], dim=-1)
            bot = torch.cat([off, Bi], dim=-1)
        else:
            off = -(Ai @ C @ Bi)
            top = torch.cat([Ai, off], dim=-1)
            bot = torch.cat([Z, Bi], dim=-1)
        X = torch.cat([top, bot], dim=-2)
        b *= 2
    return X[..., 0, :, :]


def _tiny_replace(piv: torch.Tensor, thresh: float):
    """GESP tiny-pivot replacement: |piv| < thresh → sign(piv)·thresh
    (SRC/pdgstrf2.c; counted into stat->TinyPivots); a complex pivot
    keeps its phase, piv/|piv|·thresh, and becomes thresh where it is
    exactly zero.  Also flags an exactly-zero pivot that was not
    replaced (thresh == 0, i.e. ReplaceTinyPivot=NO) — the reference's
    info=k singularity signal.  Returns (newpiv, was_tiny, was_zero)
    elementwise, counters int32."""
    apiv = piv.abs()
    is_tiny = apiv < thresh
    if piv.is_complex():
        unit = torch.where(apiv == 0, torch.ones_like(piv), piv / apiv)
    else:
        unit = torch.where(piv >= 0, 1.0, -1.0).to(piv.dtype)
    newpiv = torch.where(is_tiny, unit * thresh, piv)
    was_zero = (apiv == 0) & ~is_tiny
    return newpiv, is_tiny.to(torch.int32), was_zero.to(torch.int32)


def partial_lu_batch(F: torch.Tensor, thresh, *, wb: int,
                     nb: int = 32):
    """Factor the leading `wb` columns of each front of F (N, mb, mb)
    in place; `thresh` is a float or a one-element tensor.  Returns
    (F, tiny_count, zero_pivot_count), the counts as int64 scalars
    summed over the fronts.  A bfloat16 batch is factored in float32
    and rounded once into F: bfloat16 storage, float32 arithmetic (the
    class the TPU kernel computed in, and K1's bf16 lane)."""
    if F.dtype == torch.bfloat16:
        Fw, tiny, nzero = partial_lu_batch(F.float(), thresh, wb=wb, nb=nb)
        F.copy_(Fw)
        return F, tiny, nzero
    N, mb, _ = F.shape
    if isinstance(thresh, torch.Tensor):
        # a one-element tensor (K1's device threshold) compares in F's
        # real dtype, as a Python float does
        thresh = thresh.to(F.dtype.to_real()).reshape(())
    nb = min(nb, wb)
    if wb % nb:
        raise ValueError(f"width bucket {wb} is not a multiple of the "
                         f"block {nb}")
    tiny = torch.zeros(N, dtype=torch.int32, device=F.device)
    nzero = torch.zeros(N, dtype=torch.int32, device=F.device)
    for k0 in range(0, wb, nb):
        k1 = k0 + nb
        D = F[:, k0:k1, k0:k1]
        for t in range(nb):
            piv, was_tiny, was_zero = _tiny_replace(D[:, t, t], thresh)
            tiny += was_tiny
            nzero += was_zero
            D[:, t, t] = piv
            D[:, t + 1:, t] /= piv[:, None]
            D[:, t + 1:, t + 1:] -= (D[:, t + 1:, t:t + 1]
                                     * D[:, t:t + 1, t + 1:])
        if k1 < mb:
            U11i = _newton_tri_inverse(D, lower=False, unit=False)
            L11i = _newton_tri_inverse(D, lower=True, unit=True)
            F[:, k1:, k0:k1] = F[:, k1:, k0:k1] @ U11i
            F[:, k0:k1, k1:] = L11i @ F[:, k0:k1, k1:]
            F[:, k1:, k1:] -= F[:, k1:, k0:k1] @ F[:, k0:k1, k1:]
    return F, tiny.sum(dtype=torch.int64), nzero.sum(dtype=torch.int64)


def partial_lu(F: torch.Tensor, thresh: float, *, wb: int,
               nb: int = 32):
    """partial_lu_batch of one square front (mb, mb), in place."""
    out, tiny, nzero = partial_lu_batch(F[None], thresh, wb=wb, nb=nb)
    return out[0], tiny, nzero


def _working(T: torch.Tensor) -> torch.Tensor:
    """A bfloat16 operand widened to float32 (its arithmetic type);
    others as they are.  The caller rounds the result once on store."""
    return T.float() if T.dtype == torch.bfloat16 else T


def unit_lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """inv(L) for batched unit-lower (N, w, w) — the DiagInv
    preparation (SRC/pdgssvx.c:1436-1447) that turns the solve's TRSV
    into GEMM.  A bfloat16 L is inverted in float32 (the result comes
    back in float32)."""
    return _blocked_tri_inverse(_working(L), lower=True, unit=True)


def upper_inverse(U: torch.Tensor) -> torch.Tensor:
    """inv(U) for batched upper-triangular (N, w, w); bfloat16 as in
    unit_lower_inverse."""
    return _blocked_tri_inverse(_working(U), lower=False, unit=False)
