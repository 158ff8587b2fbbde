"""Build and load the port's CUDA kernels.

Each kernel source under superlu_dist_tpu_torch/csrc/ is compiled by
`nvcc` for sm_90a into its own shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The libraries go into the port's gitignored build directory
at first use; `build_all()` starts one nvcc per source, all together.
Nothing here runs at import time: the CPU tests import every module
and have neither nvcc nor a card.

Calling convention of every exported launcher: device pointers and the
CUDA stream as `void*`, sizes as `int64_t`, and a scalar that a
captured CUDA graph must read afresh on every replay (K1's threshold)
as a device pointer; the return value is the `cudaGetLastError()`
after the launches (0 = ok), and `slu_cuda_errstr(code)` names it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from ..utils.native import build_dir

SOURCES = ("panel_lu", "ea_scatter", "lsum", "df64_spmv")

# per-source nvcc flags beside the common ones: K4's error-free
# transformations must never be contracted into FMAs
EXTRA_FLAGS = {"df64_spmv": ("-fmad=false",)}

_lock = threading.Lock()
_libs: dict = {}


def _csrc() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"libslu_{name}.so")


def _current(name: str) -> bool:
    out = _lib_path(name)
    srcs = [os.path.join(_csrc(), f"{name}.cu"),
            os.path.join(_csrc(), "common.cuh")]
    try:
        mt = os.path.getmtime(out)
        return all(mt >= os.path.getmtime(s) for s in srcs)
    except OSError:
        return False


def _start_build(name: str, verbose: bool) -> subprocess.Popen:
    os.makedirs(build_dir(), exist_ok=True)
    out = _lib_path(name)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *EXTRA_FLAGS.get(name, ()),
           "-I", _csrc(), "-o", f"{out}.{os.getpid()}.tmp",
           os.path.join(_csrc(), f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that is missing or stale, one nvcc
    per source, all started together.  Returns {"seconds": wall,
    "log": {name: compiler output}}; raises if a build fails."""
    t0 = time.perf_counter()
    procs = {n: _start_build(n, verbose) for n in SOURCES
             if verbose or not _current(n)}
    logs = {}
    failed = []
    for name, p in procs.items():
        out, _ = p.communicate()
        logs[name] = out
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        if p.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "log": logs}


_P = ctypes.c_void_p
_I = ctypes.c_int64

# exported launchers and their argument lists (the suffix names the
# element type: bf16 / f32 / f64 real, c64 / c128 complex)
_SIGNATURES = {
    "panel_lu": {
        # F, work, N, mb, wb, regime (0 small, 1 large), thresh (one
        # float64 on the device), tiny, nzero, stream
        **{f"slu_panel_lu_{t}": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
           for t in ("bf16", "f32", "f64", "c64", "c128")},
    },
    "ea_scatter": {
        # F, upd, so, st, pr, fronts, seg, nfronts, rc_b, mb, head_dst,
        # head_src, head_src2, xptr, xsrc (null: banded variant), nheads,
        # stream
        **{f"slu_ea_scatter_{t}": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _I, _P]
           for t in ("bf16", "f32", "f64", "c64", "c128")},
    },
    "lsum": {
        # Li, Li strides (front, row), L21, L21 strides, xb, Y, UPD,
        # t, wb, rtrim, R, y_off, u_off, stream; the bfloat16 lanes take
        # a float32 workspace after UPD
        **{f"slu_lsum_{p}_{x}": [_P, _I, _I, _P, _I, _I, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P]
           for p, x in (("f32", "f32"), ("f64", "f64"), ("f32", "f64"),
                        ("c64", "c64"), ("c128", "c128"),
                        ("c64", "c128"))},
        **{f"slu_lsum_bf16_{x}": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P]
           for x in ("f32", "f64")},
    },
    "df64_spmv": {
        # cols, vals_hi, vals_lo, x_hi, x_lo, y_hi, y_lo, n, w, R, stream
        "slu_df64_ell_spmv": [_P] * 7 + [_I, _I, _I, _P],
    },
}


def library(name: str):
    """The loaded kernel library `name` (building it first if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not _current(name):
            build_all()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, args in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        lib.slu_cuda_errstr.argtypes = [ctypes.c_int]
        lib.slu_cuda_errstr.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib, rc: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() from a launcher."""
    if rc != 0:
        msg = lib.slu_cuda_errstr(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, dtypes, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        f"(expected one of {dtypes})")
