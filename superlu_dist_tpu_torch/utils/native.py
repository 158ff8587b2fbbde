"""ctypes bindings for the native host library (csrc/slu_host.cpp).

The planning passes (MC64, minimum degree, nested dissection, etree,
supernodes, symbolic factorization) run on the host in C++.  The port
compiles the repository's `csrc/slu_host.cpp` itself with g++ into its
own build directory (`superlu_dist_tpu_torch/_build/`, listed in
.gitignore) and loads it with ctypes; it never loads a library another
package built.  Every entry point has a pure-Python twin in
superlu_dist_tpu_torch/plan/ that serves as fallback and test oracle,
so the library is a host-side accelerator, never a requirement: a
failed build is remembered and the plan passes use their twins.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import flags

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)

_lock = threading.Lock()
_lib = None
_failed = False


def _pkg_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _src_path() -> str:
    return os.path.join(os.path.dirname(_pkg_dir()), "csrc",
                        "slu_host.cpp")


def build_dir() -> str:
    """The port's build directory (gitignored); SLU_KERNEL_BUILD_DIR
    moves it."""
    return (flags.env_opt("SLU_KERNEL_BUILD_DIR")
            or os.path.join(_pkg_dir(), "_build"))


def _so_path() -> str:
    return os.path.join(build_dir(), "libslu_host.so")


def _is_current(out: str, srcs) -> bool:
    try:
        mt = os.path.getmtime(out)
        return all(mt >= os.path.getmtime(s) for s in srcs)
    except OSError:
        return False


def _compile_so(src: str, out: str, timeout: int = 300) -> bool:
    """g++ -shared `src` into `out` through a pid-unique temporary
    file, so concurrent builds never load a half-written library."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    hdr_dir = os.path.dirname(src)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
             "-I", hdr_dir, src, "-o", tmp],
            check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _build() -> str | None:
    src = _src_path()
    out = _so_path()
    if not os.path.exists(src):
        return None
    hdr = os.path.join(os.path.dirname(src), "slu_cpuid.h")
    if _is_current(out, [s for s in (src, hdr) if os.path.exists(s)]):
        return out
    return out if _compile_so(src, out) else None


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        if path is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.slu_etree.argtypes = [ctypes.c_int64, _I64, _I64, _I64]
            lib.slu_postorder.argtypes = [ctypes.c_int64, _I64, _I64]
            lib.slu_colcounts.argtypes = [ctypes.c_int64, _I64, _I64,
                                          _I64, _I64]
            lib.slu_mdorder.argtypes = [ctypes.c_int64, _I64, _I64, _I64]
            lib.slu_mdorder.restype = ctypes.c_int64
            lib.slu_mc64.argtypes = [ctypes.c_int64, _I64, _I64, _F64,
                                     _I64, _F64, _F64]
            lib.slu_mc64.restype = ctypes.c_int64
            lib.slu_hwpm.argtypes = [ctypes.c_int64, _I64, _I64, _F64,
                                     ctypes.c_int64, _I64]
            lib.slu_hwpm.restype = ctypes.c_int64
            lib.slu_symbfact_create.argtypes = [
                ctypes.c_int64, _I64, _I64, ctypes.c_int64, _I64, _I64]
            lib.slu_symbfact_create.restype = ctypes.c_void_p
            lib.slu_symbfact_create_par.argtypes = [
                ctypes.c_int64, _I64, _I64, ctypes.c_int64, _I64, _I64,
                ctypes.c_int64]
            lib.slu_symbfact_create_par.restype = ctypes.c_void_p
            lib.slu_symbfact_total.argtypes = [ctypes.c_void_p]
            lib.slu_symbfact_total.restype = ctypes.c_int64
            lib.slu_symbfact_sizes.argtypes = [ctypes.c_void_p, _I64]
            lib.slu_symbfact_fill.argtypes = [ctypes.c_void_p, _I64]
            lib.slu_symbfact_free.argtypes = [ctypes.c_void_p]
            lib.slu_ndorder.argtypes = [ctypes.c_int64, _I64, _I64,
                                        ctypes.c_int64, ctypes.c_int64,
                                        _I64]
            lib.slu_ndorder.restype = ctypes.c_int64
            lib.slu_supernodes.argtypes = [ctypes.c_int64, _I64, _I64,
                                           ctypes.c_int64,
                                           ctypes.c_int64, _I64, _I64,
                                           _I64]
            lib.slu_supernodes.restype = ctypes.c_int64
            lib.slu_version.restype = ctypes.c_int64
            if lib.slu_version() != 6:
                raise OSError("unexpected slu_host library version")
            _lib = lib
        except (OSError, AttributeError):
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def native_or_none():
    """This module when the library loads, else None (the plan-layer
    dispatch probe)."""
    import sys
    mod = sys.modules[__name__]
    return mod if available() else None


def _c64(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.int64)
    return a, a.ctypes.data_as(_I64)


def _cf64(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(_F64)


def etree(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    a_pp, pp = _c64(indptr)
    a_pi, pi = _c64(indices)
    parent = np.empty(n, dtype=np.int64)
    lib.slu_etree(n, pp, pi, parent.ctypes.data_as(_I64))
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    lib = _load()
    n = len(parent)
    a_pp, pp = _c64(parent)
    post = np.empty(n, dtype=np.int64)
    lib.slu_postorder(n, pp, post.ctypes.data_as(_I64))
    return post


def col_counts(indptr: np.ndarray, indices: np.ndarray,
               parent: np.ndarray) -> np.ndarray:
    lib = _load()
    n = len(parent)
    a_pp, pp = _c64(indptr)
    a_pi, pi = _c64(indices)
    a_pa, pa = _c64(parent)
    cc = np.empty(n, dtype=np.int64)
    lib.slu_colcounts(n, pp, pi, pa, cc.ctypes.data_as(_I64))
    return cc


def amd_order(indptr: np.ndarray, indices: np.ndarray,
              n: int) -> np.ndarray:
    """Minimum-degree ordering; returns order[k] = k-th pivot."""
    lib = _load()
    a_pp, pp = _c64(indptr)
    a_pi, pi = _c64(indices)
    order = np.empty(n, dtype=np.int64)
    got = lib.slu_mdorder(n, pp, pi, order.ctypes.data_as(_I64))
    if got != n:
        raise RuntimeError(f"native mdorder returned {got} of {n} pivots")
    return order


def mc64(n: int, colptr: np.ndarray, rowind: np.ndarray,
         absval: np.ndarray):
    """MC64 job=5 on CSC input.  Returns (rowperm, u, v) where
    rowperm[i] = destination position of row i and (u, v) are the dual
    potentials."""
    lib = _load()
    a_pc, pc = _c64(colptr)
    a_pr, pr = _c64(rowind)
    a_pv, pv = _cf64(absval)
    perm = np.empty(n, dtype=np.int64)
    u = np.empty(n, dtype=np.float64)
    v = np.empty(n, dtype=np.float64)
    rc = lib.slu_mc64(n, pc, pr, pv, perm.ctypes.data_as(_I64),
                      u.ctypes.data_as(_F64), v.ctypes.data_as(_F64))
    if rc != 0:
        raise ValueError("structurally singular matrix (native mc64)")
    return perm, u, v


def hwpm(n: int, colptr: np.ndarray, rowind: np.ndarray,
         absval: np.ndarray, threads: int = 0):
    """Approximate heavy-weight perfect matching on CSC input; returns
    rowperm only.  threads=0 -> hardware concurrency."""
    lib = _load()
    a_pc, pc = _c64(colptr)
    a_pr, pr = _c64(rowind)
    a_pv, pv = _cf64(absval)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.slu_hwpm(n, pc, pr, pv, threads,
                      perm.ctypes.data_as(_I64))
    if rc == -2:
        raise OverflowError("n exceeds the 2^32 row-id packing limit "
                            "of the hwpm proposal key")
    if rc != 0:
        raise ValueError("structurally singular matrix (native hwpm)")
    return perm


def nd_order(indptr: np.ndarray, indices: np.ndarray, n: int,
             leaf_size: int = 48, threads: int = 1) -> np.ndarray:
    """Nested-dissection ordering; returns order[k] = k-th pivot.
    Identical output to plan/nested.nd_order (the oracle)."""
    lib = _load()
    a_pp, pp = _c64(indptr)
    a_pi, pi = _c64(indices)
    out = np.empty(n, dtype=np.int64)
    got = lib.slu_ndorder(n, pp, pi, leaf_size, threads,
                          out.ctypes.data_as(_I64))
    if got != n:
        raise RuntimeError(f"native ndorder returned {got} of {n}")
    return out


def supernodes(parent: np.ndarray, colcount: np.ndarray, relax: int,
               max_super: int):
    """Supernode partition; returns (nsuper, xsup, supno, sparent) —
    bit-identical to plan/supernodes.find_supernodes (the oracle)."""
    lib = _load()
    n = len(parent)
    a_pp, pp = _c64(parent)
    a_pc, pc = _c64(colcount)
    supno = np.empty(n, dtype=np.int64)
    xsup = np.empty(n + 1, dtype=np.int64)
    sparent = np.empty(n if n else 1, dtype=np.int64)
    ns = int(lib.slu_supernodes(n, pp, pc, relax, max_super,
                                supno.ctypes.data_as(_I64),
                                xsup.ctypes.data_as(_I64),
                                sparent.ctypes.data_as(_I64)))
    return ns, xsup[:ns + 1].copy(), supno, sparent[:ns].copy()


def symbfact(n: int, b_indptr: np.ndarray, b_indices: np.ndarray,
             nsuper: int, xsup: np.ndarray, sparent: np.ndarray,
             threads: int = 1):
    """Supernodal symbolic factorization.  Returns a list of
    per-supernode sorted off-block row index arrays.  threads > 1
    runs the level-parallel variant (identical output)."""
    lib = _load()
    a_pp, pp = _c64(b_indptr)
    a_pi, pi = _c64(b_indices)
    a_px, px = _c64(xsup)
    a_ps, ps = _c64(sparent)
    if threads > 1:
        h = lib.slu_symbfact_create_par(n, pp, pi, nsuper, px, ps,
                                        threads)
    else:
        h = lib.slu_symbfact_create(n, pp, pi, nsuper, px, ps)
    if not h:
        raise MemoryError("slu_symbfact_create failed")
    try:
        sizes = np.empty(nsuper, dtype=np.int64)
        lib.slu_symbfact_sizes(h, sizes.ctypes.data_as(_I64))
        flat = np.empty(int(lib.slu_symbfact_total(h)), dtype=np.int64)
        lib.slu_symbfact_fill(h, flat.ctypes.data_as(_I64))
    finally:
        lib.slu_symbfact_free(h)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [flat[offs[s]:offs[s + 1]] for s in range(nsuper)]
