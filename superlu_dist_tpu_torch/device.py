"""Device resolution for the entry points.

The port's numeric phases run on the CUDA card.  A caller that wants
the CPU (the tests, which run the kernels' plain versions there) says
so with `device="cpu"`; with no card and no such request the entry
points raise instead of quietly running on the host.
"""

from __future__ import annotations

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


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or name) -> torch dtype."""
    import numpy as np
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32,
            np.dtype(np.complex128): torch.complex128,
            np.dtype(np.complex64): torch.complex64}[np.dtype(dtype)]


def upload_int64(arrays, device) -> list:
    """Many host index arrays to `device` as int64 in one copy,
    returned as views of one buffer.  A host→device copy from pageable
    memory synchronises the stream, so a schedule's thousands of small
    index arrays must not go over one by one."""
    import numpy as np
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
