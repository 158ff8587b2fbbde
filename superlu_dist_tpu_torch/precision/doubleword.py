"""Double-word ("df64") arithmetic: ~2× fp32 precision from fp32 ops.

The psgssvx_d2 mixed-precision driver (SRC/psgssvx_d2.c:516) factors in
single and recovers double accuracy through iterative refinement whose
residual r = b − A·x is accumulated in double (SRC/psgsrfs_d2.c:229).
The fused device loop's doubleword mode (ops/batched.make_fused_solver,
residual_mode="doubleword") accumulates that residual instead in
double-word numbers: an unevaluated sum of two fp32 values (hi, lo)
with |lo| ≤ ½ulp(hi), ~48 significant bits, every operation below an
error-free fp32 transformation (Dekker 1971; Knuth TAOCP §4.2.2; the
double-double technique of Bailey/Hida/Li's QD library).

The reference package's precision/doubleword.py, in PyTorch.  Each
function is a sequence of single-operation torch calls in the
reference's order (no `alpha=`, no addcmul/addcdiv: a fused elementwise
kernel could contract a product into an add and destroy the rounding
error the transformation exists to keep), so on the CPU it is bitwise
the reference's functions run eagerly.  These are also the plain
version of kernel K4 (ops/df64_spmv.py, csrc/df64_spmv.cu), which runs
the same operations in the same order and is held bitwise to them on
the card.  The reference's `_match_shapes` promoted broadcast operands
through an unfoldable identity to dodge XLA:CPU's contraction; eager
torch does not contract, so broadcasting is `torch.broadcast_tensors`.

`split_f64` / `join_f64` convert float64 values to and from exact
(hi, lo) fp32 pairs on the host (numpy); `split_f64_tensor` /
`join_f64_tensor` do the same for tensors already on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# fp32 has a 24-bit significand: Dekker's splitter is 2^ceil(24/2)+1
_SPLIT = 4097.0          # 2**12 + 1

# Convergence target of the doubleword refinement loop: 2^-24 per limb
# compounds to ~2^-48 relative; 2^-44 leaves 4 bits of slack for the
# SpMV accumulation ladder (the reference's DF64_EPS)
DF64_EPS = float(2.0 ** -44)


def _bcast(a, b):
    """The two operands at their common shape (a Python number becomes
    a float32 tensor on its partner's device)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=torch.float32, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return torch.broadcast_tensors(a, b)


# -- error-free transformations --------------------------------------

def two_sum(a, b):
    """fl(a+b) and its exact rounding error (Knuth; 6 flops,
    branch-free, no |a| ≥ |b| precondition)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """fl(a+b) and its exact error, requiring |a| ≥ |b| (or a == 0):
    Dekker's 3-flop renormalization step."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    """Dekker split: a == hi + lo with both halves carrying ≤ 12
    significand bits, so products of halves are exact in fp32."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """fl(a·b) and its exact rounding error (Dekker; FMA-free)."""
    a, b = _bcast(a, b)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# -- df64 arithmetic (operands/results are (hi, lo) fp32 pairs) ------

def df_add(x, y):
    """Double-word + double-word (Knuth accurate add, ~20 flops;
    relative error a few 2^-48)."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def df_neg(x):
    return -x[0], -x[1]


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_add_f(x, f):
    """Double-word + fp32 (the refinement update x ← x + δ with a
    single-precision correction δ)."""
    s1, s2 = two_sum(x[0], f)
    s2 = s2 + x[1]
    return quick_two_sum(s1, s2)


def df_mul(x, y):
    """Double-word × double-word (the x[1]·y[1] term is below the
    result's precision and is dropped, per the standard algorithm).
    Pairs of different shapes (value planes against multi-RHS
    vectors) broadcast."""
    xh, yh = _bcast(x[0], y[0])
    xl, yl = _bcast(x[1], y[1])
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def df_mul_f(x, f):
    """Double-word × fp32."""
    xh, f = _bcast(x[0], f)
    p, e = two_prod(xh, f)
    e = e + x[1] * f
    return quick_two_sum(p, e)


def df_axpy(alpha, x, y):
    """y + alpha·x with df64 pairs (alpha an fp32 scalar or pair)."""
    ax = df_mul(x, alpha) if isinstance(alpha, tuple) \
        else df_mul_f(x, alpha)
    return df_add(y, ax)


def df_sum(terms_hi, terms_lo, dim: int = 0):
    """Compensated reduction of df64 terms along `dim`: df_add from a
    zero pair, one term at a time in index order (the reference's
    `lax.scan`).  Error O(k·2^-48) instead of a plain fp32 sum's
    O(k·2^-24)."""
    th = torch.movedim(terms_hi, dim, 0)
    tl = torch.movedim(terms_lo, dim, 0)
    sh = torch.zeros(th.shape[1:], dtype=torch.float32, device=th.device)
    sl = torch.zeros_like(sh)
    for k in range(th.shape[0]):
        sh, sl = df_add((sh, sl), (th[k], tl[k]))
    return sh, sl


def df_dot(x, y):
    """df64 inner product of two df64 vectors ((hi, lo) pairs of 1-D
    fp32 tensors)."""
    ph, pl = df_mul(x, y)
    return df_sum(ph, pl, dim=0)


# -- residual-SpMV accumulation lanes --------------------------------

def df64_ell_spmv(ell_cols, vals_hi, vals_lo, x_hi, x_lo):
    """y = A·x with A in padded-ELL form and both A and x double-word:
    per-row gather of the fixed band, df_mul per term, and df_sum over
    the band in slot order.  `ell_cols` (n, w) column indices inside x
    (pad slots any valid index), `vals_hi/vals_lo` the (n, w) value
    planes of the exact fp32 split (pad slots 0 in both), `x_hi/x_lo`
    (n,) or (n, nrhs).  Returns the (hi, lo) pair.  The plain version
    of kernel K4."""
    xgh = x_hi[ell_cols]                   # (n, w[, nrhs]) pure gather
    xgl = x_lo[ell_cols]
    if x_hi.dim() == 2:
        vh = vals_hi[:, :, None]
        vl = vals_lo[:, :, None]
    else:
        vh, vl = vals_hi, vals_lo
    th, tl = df_mul((vh, vl), (xgh, xgl))
    return df_sum(th, tl, dim=1)


def df64_coo_spmv(rows, cols, vals_hi, vals_lo, x_hi, x_lo, n: int):
    """COO lane: the term products are exact df64 pairs, but the row
    accumulation is two independent fp32 scatter-adds (hi plane and
    error plane), so the sum stays fp32-class.  Strictly better than a
    plain fp32 product, strictly worse than the ELL lane; a doubleword
    residual therefore takes ELL unless SLU_SPMV_LAYOUT=coo insists.
    `rows` may carry the sentinel n (that entry is dropped)."""
    xgh = x_hi.index_select(0, cols)
    xgl = x_lo.index_select(0, cols)
    if x_hi.dim() == 2:
        vh, vl = vals_hi[:, None], vals_lo[:, None]
    else:
        vh, vl = vals_hi, vals_lo
    th, tl = df_mul((vh, vl), (xgh, xgl))
    shape = (n + 1,) + tuple(x_hi.shape[1:])
    z = dict(dtype=torch.float32, device=x_hi.device)
    yh = torch.zeros(shape, **z).index_add_(0, rows, th)
    yl = torch.zeros(shape, **z).index_add_(0, rows, tl)
    return quick_two_sum(yh[:n], yl[:n])


# -- conversion to and from float64 -----------------------------------

def split_f64(v):
    """Exact numpy split of float64 values into (hi, lo) float32
    planes: hi = fl32(v), lo = fl32(v − hi).  The subtraction runs in
    f64 on the host, and |v| < 2^127 makes both roundings exact, so
    hi + lo == v to df64 precision."""
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    """Recombine a (hi, lo) pair into float64 on the host."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def split_f64_tensor(v: torch.Tensor):
    """split_f64 of a tensor, on its own device (float64 arithmetic
    outside any df64 program: the split is an input conversion)."""
    v = v.to(torch.float64)
    hi = v.to(torch.float32)
    return hi, (v - hi.to(torch.float64)).to(torch.float32)


def join_f64_tensor(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """join_f64 of two tensors, on their device."""
    return hi.to(torch.float64) + lo.to(torch.float64)
