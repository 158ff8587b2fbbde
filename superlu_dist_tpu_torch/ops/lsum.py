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
that launched the kernel.
The transposed lane stays the PyTorch formulation
(trisolve._fwd_member), as in the reference, whose Pallas kernel never
took it.
"""

from __future__ import annotations

import torch

from . import _cuda

_NAMES = {(torch.float32, torch.float32): "slu_lsum_f32_f32",
          (torch.float64, torch.float64): "slu_lsum_f64_f64",
          (torch.float32, torch.float64): "slu_lsum_f32_f64"}


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
    _cuda.require_cuda(xb, (torch.float32, torch.float64), "lsum")
    name = _NAMES.get((Li_p.dtype, xb.dtype))
    if name is None or L21_p.dtype != Li_p.dtype:
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
    rc = getattr(lib, name)(
        Li_p.data_ptr(), Li_p.stride(0), Li_p.stride(1),
        L21_p.data_ptr(), L21_p.stride(0), L21_p.stride(1),
        xb.data_ptr(), Y.data_ptr(), UPD.data_ptr(),
        t, wb, rtrim, R, y_off, u_off, _cuda.stream_ptr(xb))
    _cuda.check(lib, rc, "lsum")
    lsum_panel.launches += 1


lsum_panel.launches = 0


def bound_work(t: int, wb: int, rtrim: int, R: int, psize: int,
               xsize: int) -> tuple:
    """(flops, bytes) of one lsum_panel call on t fronts: y = Li·xb and
    upd = L21[:rtrim]·y, each panel element (psize bytes) read once, xb
    read once, y and upd (xsize bytes) written once."""
    flops = 2.0 * t * (wb * wb + rtrim * wb) * R
    nbytes = ((t * wb * wb + t * rtrim * wb) * psize + t * wb * R * xsize
              + t * (wb + rtrim) * R * xsize)
    return flops, nbytes
