"""Complex dense kernels in real-pair arithmetic (pair storage).

A complex array of shape S is carried as a real array of shape (2,) + S,
plane 0 real and plane 1 imaginary: the storage of a factorization made
under SLU_COMPLEX_PAIR=1 (ops/batched.py).  These are the reference's
`ops/pair_lu.py` functions as plain PyTorch tensor functions: a complex
multiply is the four-product cross form, a divide goes through the |b|²
denominator, a complex product is four real products.  They are the
pair storage's plain version on the CPU and the oracle of the card's
pair factorization, which runs K1's complex lane on a complex copy of
the planes instead (ops/batched.factor_group).

`partial_lu_pair` mirrors ops/dense_lu.partial_lu, GESP tiny-pivot
replacement included (|piv| < thresh → piv/|piv|·thresh); the
triangular inverses mirror dense_lu's Newton / blocked recursion.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------- algebra

def pmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(ar + i·ai)(br + i·bi) on (2, …) pair tensors (broadcasting)."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br])


def pdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b on pair tensors, through the |b|² denominator."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    den = br * br + bi * bi
    return torch.stack([(ar * br + ai * bi) / den,
                        (ai * br - ar * bi) / den])


def pabs(a: torch.Tensor) -> torch.Tensor:
    """|a|, a real tensor without the plane axis."""
    return torch.sqrt(a[0] * a[0] + a[1] * a[1])


def pmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A complex product as four real ones: (2, …, m, k) @ (2, …, k, n)."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    return torch.stack([ar @ br - ai @ bi, ar @ bi + ai @ br])


def peinsum(sub: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A complex einsum over pair tensors (`sub` is the per-plane
    spec)."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    rr = torch.einsum(sub, ar, br) - torch.einsum(sub, ai, bi)
    ri = torch.einsum(sub, ar, bi) + torch.einsum(sub, ai, br)
    return torch.stack([rr, ri])


def encode(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (2, …) real pair."""
    return torch.stack([x.real, x.imag])


def decode(xp: torch.Tensor) -> torch.Tensor:
    """A (2, …) real pair as the complex tensor."""
    return torch.complex(xp[0], xp[1])


def _eye_pair(k: int, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """The complex identity as a pair, its plane axis leading and
    broadcastable against a (2, batch…, k, k) pair of rank `ndim`."""
    eye = torch.eye(k, dtype=like.dtype, device=like.device)
    return torch.stack([eye, torch.zeros_like(eye)]).reshape(
        (2,) + (1,) * (ndim - 3) + (k, k))


# ------------------------------------------------- triangular inverses

def _newton_tri_inverse_pair(T: torch.Tensor, *, lower: bool,
                             unit: bool) -> torch.Tensor:
    """inv(T) of a pair triangular (2, …, k, k) by Newton iteration
    X ← X(2I − TX), exact after ⌈log2 k⌉ steps, every step a pair
    product."""
    k = T.shape[-1]
    E = _eye_pair(k, T.dim(), T)
    keep = (torch.tril(torch.ones(k, k, dtype=torch.bool,
                                  device=T.device), -1) if lower else
            torch.triu(torch.ones(k, k, dtype=torch.bool,
                                  device=T.device), 1))
    N = torch.where(keep, T, torch.zeros((), dtype=T.dtype,
                                         device=T.device))
    if unit:
        X = E - N
        A = E + N
    else:
        d = torch.diagonal(T, dim1=-2, dim2=-1).unsqueeze(-1)
        Nn = pdiv(N, d)
        X = E - Nn
        A = E + Nn
    steps = max(0, (k - 1).bit_length() - 1)
    for _ in range(steps):
        X = pmatmul(X, 2 * E - pmatmul(A, X))
    if not unit:
        X = pdiv(X, d.transpose(-1, -2))
    return X


def _blocked_tri_inverse_pair(T: torch.Tensor, *, lower: bool,
                              unit: bool, base: int = 64) -> torch.Tensor:
    """inv(T) of a pair triangular by 2×2 block recursion with Newton
    leaves."""
    k = T.shape[-1]
    if k <= base:
        return _newton_tri_inverse_pair(T, lower=lower, unit=unit)
    h = k // 2
    A = T[..., :h, :h]
    B = T[..., h:, h:]
    Ai = _blocked_tri_inverse_pair(A, lower=lower, unit=unit, base=base)
    Bi = _blocked_tri_inverse_pair(B, lower=lower, unit=unit, base=base)
    if lower:
        C = T[..., h:, :h]
        off = -pmatmul(pmatmul(Bi, C), Ai)
        top = torch.cat([Ai, torch.zeros_like(C.transpose(-1, -2))],
                        dim=-1)
        bot = torch.cat([off, Bi], dim=-1)
    else:
        C = T[..., :h, h:]
        off = -pmatmul(pmatmul(Ai, C), Bi)
        top = torch.cat([Ai, off], dim=-1)
        bot = torch.cat([torch.zeros_like(C.transpose(-1, -2)), Bi],
                        dim=-1)
    return torch.cat([top, bot], dim=-2)


def unit_lower_inverse_pair(L: torch.Tensor) -> torch.Tensor:
    """inv(L) of a pair unit-lower (2, N, w, w)."""
    return _blocked_tri_inverse_pair(L, lower=True, unit=True)


def upper_inverse_pair(U: torch.Tensor) -> torch.Tensor:
    """inv(U) of a pair upper-triangular (2, N, w, w)."""
    return _blocked_tri_inverse_pair(U, lower=False, unit=False)


# ------------------------------------------------------- partial LU

def _tiny_replace_pair(piv: torch.Tensor, thresh):
    """GESP tiny-pivot replacement on pair pivots (2, …): |piv| <
    thresh → piv/|piv|·thresh (1·thresh where piv is exactly zero).
    Returns (newpiv, was_tiny, was_zero), the flags int32; a zero pivot
    counts as zero only when it was not replaced (thresh == 0)."""
    apiv = pabs(piv)
    is_tiny = apiv < thresh
    one = torch.zeros_like(piv)
    one[0] = 1
    safe = torch.where(apiv == 0, torch.ones_like(apiv), apiv)
    unit = torch.where(apiv == 0, one, piv / safe)
    newpiv = torch.where(is_tiny, unit * thresh, piv)
    was_zero = (apiv == 0) & ~is_tiny
    return newpiv, is_tiny.to(torch.int32), was_zero.to(torch.int32)


def partial_lu_pair(F: torch.Tensor, thresh, *, wb: int, nb: int = 32):
    """Factor the leading `wb` columns of the pair front F (2, mb, mb)
    in place.  Returns (F, tiny_count, zero_pivot_count): F holds L
    (unit lower, columns < wb), U (upper, rows < wb) and the Schur
    complement F[:, wb:, wb:]."""
    out, tiny, nzero = partial_lu_pair_batch(F[:, None], thresh, wb=wb,
                                             nb=nb)
    return out[:, 0], tiny, nzero


def partial_lu_pair_batch(F: torch.Tensor, thresh, *, wb: int,
                          nb: int = 32):
    """partial_lu_pair over a batch of pair fronts F (2, N, mb, mb), in
    place, the fronts at once.  Returns (F, tiny_count,
    zero_pivot_count), the counts int64 scalars summed over the
    fronts.  The same blocked structure as dense_lu.partial_lu_batch:
    rank-1 elimination on each (nb, nb) diagonal block, then the panels
    and the trailing update as pair products."""
    _, N, mb, _ = F.shape
    if isinstance(thresh, torch.Tensor):
        thresh = thresh.to(F.dtype).reshape(())
    nb = min(nb, wb)
    if wb % nb:
        raise ValueError(f"width bucket {wb} is not a multiple of the "
                         f"block {nb}")
    tiny = torch.zeros(N, dtype=torch.int32, device=F.device)
    nzero = torch.zeros(N, dtype=torch.int32, device=F.device)
    for k0 in range(0, wb, nb):
        k1 = k0 + nb
        D = F[:, :, k0:k1, k0:k1]
        for t in range(nb):
            piv, was_tiny, was_zero = _tiny_replace_pair(D[:, :, t, t],
                                                         thresh)
            tiny += was_tiny
            nzero += was_zero
            D[:, :, t, t] = piv
            D[:, :, t + 1:, t] = pdiv(D[:, :, t + 1:, t],
                                      piv[:, :, None])
            D[:, :, t + 1:, t + 1:] -= pmul(D[:, :, t + 1:, t:t + 1],
                                            D[:, :, t:t + 1, t + 1:])
        if k1 < mb:
            U11i = _newton_tri_inverse_pair(D, lower=False, unit=False)
            L11i = _newton_tri_inverse_pair(D, lower=True, unit=True)
            F[:, :, k1:, k0:k1] = pmatmul(F[:, :, k1:, k0:k1], U11i)
            F[:, :, k0:k1, k1:] = pmatmul(L11i, F[:, :, k0:k1, k1:])
            F[:, :, k1:, k1:] -= pmatmul(F[:, :, k1:, k0:k1],
                                         F[:, :, k0:k1, k1:])
    return F, tiny.sum(dtype=torch.int64), nzero.sum(dtype=torch.int64)
