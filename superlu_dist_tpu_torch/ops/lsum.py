"""Kernel K3: the fused forward lsum step (csrc/lsum.cu).

Replaces the reference's Pallas kernel
superlu_dist_tpu/ops/pallas_lsum.py (`lsum_panel` / `fwd_member`):
for one forward trisolve group, y = Li·xb then upd = L21[:rtrim]·y,
with y kept on chip and both results written straight into the dense
solve buffers Y (at y_off) and UPD (at u_off).

On CUDA tensors `lsum_panel` launches the kernel (one launch for
narrow fronts, two for wide ones: y, then upd; csrc/lsum.cu picks by
shape, never a library call); on CPU tensors it runs the plain version
(`lsum_panel_plain`: the two batched products of
trisolve._fwd_member).  `lsum_panel.launches` counts wrapper calls
that launched the kernel, and `lsum_panel.lanes` the same calls per
lane (panel dtype _ right-hand-side dtype, as in `LANES`).

The kernel has real lanes (float32 and float64 panels, float32 panels
with float64 right-hand sides) and complex ones (complex64, complex128,
complex64 panels with complex128 right-hand sides) and bfloat16 ones
(bfloat16 panels with float32 or float64 right-hand sides: a bfloat16
factorization solves with a promoted right-hand side; up to
BF16_ROWS_MAX right-hand sides each panel value is widened as it is
read, above the float32-panel lanes run on a widened copy).  Real
panels with complex right-hand sides take the real lanes on the
right-hand sides' 2R real columns (`torch.view_as_real`), as the
reference's `_mm_enc` codec does.  The transposed lane stays the
PyTorch formulation (trisolve._fwd_member), as in the reference, whose
Pallas kernel never took it.
"""

from __future__ import annotations

import collections

import torch

from . import _cuda

# (panel dtype, right-hand-side dtype) -> the kernel's lane (the suffix
# of its launcher's name)
LANES = {(torch.float32, torch.float32): "f32_f32",
         (torch.float64, torch.float64): "f64_f64",
         (torch.float32, torch.float64): "f32_f64",
         (torch.complex64, torch.complex64): "c64_c64",
         (torch.complex128, torch.complex128): "c128_c128",
         (torch.complex64, torch.complex128): "c64_c128",
         (torch.bfloat16, torch.float32): "bf16_f32",
         (torch.bfloat16, torch.float64): "bf16_f64"}

# the most right-hand sides the bfloat16 lanes' own kernel takes
# (lsum.cu `bf16_rows`); above, a widened float32 copy of the panels
BF16_ROWS_MAX = 4


def _as_real_columns(t: torch.Tensor) -> torch.Tensor:
    """A contiguous complex (..., R) tensor as real (..., 2R) columns,
    re and im interleaved: a view, no copy."""
    return torch.view_as_real(t).flatten(-2)


def lsum_panel_plain(Li_p, L21_p, xb, Y, UPD, y_off: int, u_off: int,
                     rtrim: int) -> None:
    """y = Li·xb, upd = L21[:, :rtrim]·y, written into Y[y_off:] and
    UPD[u_off:] (in place).  Panels are promoted to the right-hand
    side's dtype for the products."""
    R = xb.shape[-1]
    y = torch.bmm(Li_p.to(xb.dtype), xb)
    Y[y_off:y_off + y.shape[0] * y.shape[1]] = y.reshape(-1, R)
    upd = torch.bmm(L21_p[:, :rtrim, :].to(xb.dtype), y)
    UPD[u_off:u_off + upd.shape[0] * rtrim] = upd.reshape(-1, R)


def lsum_panel(Li_p, L21_p, xb, Y, UPD, y_off: int, u_off: int,
               rtrim: int) -> None:
    """Li_p (t, wb, wb) and L21_p (t, rb, wb) panels (unit stride along
    their last axis), xb (t, wb, R) contiguous, Y and UPD row-major
    (rows, R) buffers."""
    if xb.device.type == "cpu":
        lsum_panel_plain(Li_p, L21_p, xb, Y, UPD, y_off, u_off, rtrim)
        return
    _cuda.require_cuda(xb, tuple({x for _, x in LANES}), "lsum")
    if (xb.is_complex() and not Li_p.is_complex() and xb.is_contiguous()
            and Y.is_contiguous() and UPD.is_contiguous()):
        # real factors, complex right-hand sides: a real panel acts on
        # re and im alike, so the real lane runs on 2R real columns
        # (the reference's _mm_enc codec)
        xb, Y, UPD = (_as_real_columns(t) for t in (xb, Y, UPD))
    lane = LANES.get((Li_p.dtype, xb.dtype))
    if lane is None or L21_p.dtype != Li_p.dtype:
        raise TypeError(f"lsum: panel dtype {Li_p.dtype} with "
                        f"right-hand sides {xb.dtype} not supported")
    t, wb, R = xb.shape
    if not (xb.is_contiguous() and Y.is_contiguous()
            and UPD.is_contiguous() and Li_p.stride(2) == 1
            and L21_p.stride(2) == 1 and Y.dtype == xb.dtype
            and UPD.dtype == xb.dtype):
        raise ValueError("lsum: operand layout not supported")
    if rtrim > L21_p.shape[1] or Li_p.shape[:2] != (t, wb):
        raise ValueError("lsum: panel shapes do not match xb")
    lib = _cuda.library("lsum")
    ptrs = (Li_p.data_ptr(), Li_p.stride(0), Li_p.stride(1),
            L21_p.data_ptr(), L21_p.stride(0), L21_p.stride(1),
            xb.data_ptr(), Y.data_ptr(), UPD.data_ptr())
    if Li_p.dtype == torch.bfloat16:
        # above BF16_ROWS_MAX right-hand sides the panels are widened
        # into this float32 workspace and the float32-panel lanes run
        work = (torch.empty(t * (wb + rtrim) * wb, dtype=torch.float32,
                            device=xb.device)
                if R > BF16_ROWS_MAX else None)
        ptrs += (work.data_ptr() if work is not None else None,)
    rc = getattr(lib, f"slu_lsum_{lane}")(
        *ptrs, t, wb, rtrim, R, y_off, u_off, _cuda.stream_ptr(xb))
    _cuda.check(lib, rc, "lsum")
    lsum_panel.launches += 1
    lsum_panel.lanes[lane] += 1


lsum_panel.launches = 0
lsum_panel.lanes = collections.Counter()


def bound_work(t: int, wb: int, rtrim: int, R: int, psize: int,
               xsize: int) -> tuple:
    """(flops, bytes) of one lsum_panel call on t fronts: y = Li·xb and
    upd = L21[:rtrim]·y, each panel element (psize bytes) read once, xb
    read once, y and upd (xsize bytes) written once."""
    flops = 2.0 * t * (wb * wb + rtrim * wb) * R
    nbytes = ((t * wb * wb + t * rtrim * wb) * psize + t * wb * R * xsize
              + t * (wb + rtrim) * R * xsize)
    return flops, nbytes
