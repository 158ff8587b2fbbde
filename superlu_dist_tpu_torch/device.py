"""Device resolution for the entry points.

The port's numeric phases run on the CUDA card.  A caller that wants
the CPU (the tests, which run the kernels' plain versions there) says
so with `device="cpu"`; with no card and no such request the entry
points raise instead of quietly running on the host.

`dtype_info` is the one place that answers dtype questions (torch
dtype, bytes, realness, eps) for every spelling of a dtype, bfloat16
included, without numpy's help.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


class NoCudaDeviceError(RuntimeError):
    """No CUDA device is available and the caller did not ask for the
    CPU explicitly."""


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises NoCudaDeviceError when
    there is none); anything else is taken as the caller's explicit
    choice.  A CUDA device always comes back with its index ("cuda" ->
    "cuda:<current>"): the device caches (a schedule's index sets, the
    graph sets) are keyed by the device's name, and one card must have
    one name."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(f"device {device!r} requested but "
                                    "CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# the element types the port knows, by name.  bfloat16 has no numpy
# dtype unless the ml_dtypes package is loaded, which the port never
# requires, so every dtype question goes through `dtype_info` and never
# through np.dtype / np.finfo on a name
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64, "complex128": torch.complex128}
_NAME = {v: k for k, v in _TORCH.items()}


@dataclasses.dataclass(frozen=True)
class DTypeInfo:
    """One element type: its name, torch dtype, bytes per element,
    realness and unit roundoff (eps of its real precision)."""
    name: str
    torch: torch.dtype
    itemsize: int
    is_complex: bool
    eps: float

    @property
    def numpy(self) -> np.dtype:
        """The numpy dtype; bfloat16 has none (without ml_dtypes)."""
        if self.name == "bfloat16":
            raise TypeError("bfloat16 has no numpy dtype here (numpy "
                            "needs the ml_dtypes package for it, which "
                            "the port does not use): bfloat16 values "
                            "live in torch tensors only")
        return np.dtype(self.name)

    @property
    def working(self) -> "DTypeInfo":
        """The type arithmetic on this type's values runs in, and the
        one that holds them exactly on the host: itself, float32 for
        bfloat16 (a storage type only)."""
        return dtype_info("float32") if self.name == "bfloat16" else self

    @property
    def handle(self):
        """What a factor handle records as its dtype: the numpy dtype,
        or torch.bfloat16 where numpy has none."""
        return self.torch if self.name == "bfloat16" else self.numpy

    @property
    def real(self) -> "DTypeInfo":
        return dtype_info(self.torch.to_real())


def _dtype_name(dtype) -> str:
    if isinstance(dtype, DTypeInfo):
        return dtype.name
    if isinstance(dtype, torch.dtype):
        name = _NAME.get(dtype)
    elif isinstance(dtype, str) and dtype in _TORCH:
        name = dtype
    else:
        # numpy dtypes, scalar types and other spellings ("f8", float);
        # an ml_dtypes bfloat16 dtype names itself "bfloat16"
        name = np.dtype(dtype).name
    if name not in _TORCH:
        raise TypeError(f"unsupported dtype {dtype!r}; expected one of "
                        f"{tuple(_TORCH)}")
    return name


@functools.lru_cache(maxsize=None)
def _info(name: str) -> DTypeInfo:
    t = _TORCH[name]
    return DTypeInfo(name=name, torch=t, itemsize=t.itemsize,
                     is_complex=t.is_complex,
                     eps=float(torch.finfo(t).eps))


def dtype_info(dtype) -> DTypeInfo:
    """Any spelling of a dtype (a name, a numpy dtype or scalar type, a
    torch dtype, a DTypeInfo) -> its DTypeInfo.  Raises TypeError on a
    type the port does not know."""
    return _info(_dtype_name(dtype))


def torch_dtype(dtype) -> torch.dtype:
    """Any spelling of a dtype -> torch dtype."""
    return dtype_info(dtype).torch


def solve_dtype(factor, rhs) -> torch.dtype:
    """The dtype a sweep runs in: the factor dtype promoted against the
    right-hand side's, and at least float32 (a bfloat16 factor's
    panels are widened as the sweep reads them; K3 has no bfloat16
    right-hand-side lane)."""
    return dtype_info(torch.promote_types(torch_dtype(factor),
                                          torch_dtype(rhs))).working.torch


def upload_int64(arrays, device) -> list:
    """Many host index arrays to `device` as int64 in one copy,
    returned as views of one buffer.  A host→device copy from pageable
    memory synchronises the stream, so a schedule's thousands of small
    index arrays must not go over one by one."""
    flat = (np.concatenate([np.asarray(a, dtype=np.int64).ravel()
                            for a in arrays])
            if arrays else np.zeros(0, dtype=np.int64))
    buf = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        shape = np.shape(a)
        n = int(np.prod(shape)) if shape else 1
        out.append(buf[off:off + n].view(shape))
        off += n
    return out
