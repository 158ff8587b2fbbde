"""The port stands alone: it imports neither jax nor the JAX package
(nor ml_dtypes, which numpy would need for bfloat16), and its entry
points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "superlu_dist_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "superlu_dist_tpu", "ml_dtypes")


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import superlu_dist_tpu_torch\n"
        "import superlu_dist_tpu_torch.interop\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "superlu_dist_tpu_torch" in out
    bad = [m for m in out if _forbidden(m)]
    assert not bad, bad


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_import_of_jax_or_reference_in_source():
    offenders = []
    for path in _py_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, ROOT), n)
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_entry_points_refuse_silent_cpu(monkeypatch):
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.device import NoCudaDeviceError
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = laplacian_2d(4)
    b = np.ones(a.n)
    with pytest.raises(NoCudaDeviceError):
        st.gssvx(st.Options(), a, b)
    with pytest.raises(NoCudaDeviceError):
        st.plan_factorization(a)
    with pytest.raises(NoCudaDeviceError):
        st.factorize(a)
    # the explicit request runs
    x, _, _ = st.gssvx(st.Options(), a, b, device="cpu")
    assert np.allclose(a.to_scipy() @ x, b)


def test_lu_from_arrays_refuses_silent_cpu(monkeypatch):
    """The carrier of the reference's factors resolves its device as
    gssvx does: no card and no `device` raises; "cpu" runs."""
    import torch
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch import interop
    from superlu_dist_tpu_torch.device import NoCudaDeviceError
    from superlu_dist_tpu_torch.ops import batched
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    plan = st.plan_factorization(laplacian_2d(4), device="cpu")
    panels = [tuple(np.zeros(n) for n in (
        g.n_loc * g.mb * g.wb, g.n_loc * g.wb * g.mb,
        g.n_loc * g.wb * g.wb, g.n_loc * g.wb * g.wb))
        for g in batched.get_schedule(plan).groups]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        interop.lu_from_arrays(plan, panels, np.float64)
    lu = interop.lu_from_arrays(plan, panels, np.float64, "cpu")
    assert all(t.device.type == "cpu" for p in lu.panels for t in p)


def test_complex_refused_with_roadmap_pointer(monkeypatch):
    """Pair storage (SLU_COMPLEX_PAIR=1, ROADMAP item 10b) runs: a
    complex system under it factors on (2, N) real planes, never on
    native storage in their place, and solves to the native complex
    path's x to 1e-10 relative."""
    import superlu_dist_tpu_torch as st
    from superlu_dist_tpu_torch.utils.testmat import helmholtz_2d
    a = helmholtz_2d(4)
    b = np.ones(a.n, complex)
    x0, lu0, _ = st.gssvx(st.Options(), a, b, device="cpu")
    monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
    x1, lu1, _ = st.gssvx(st.Options(), a, b, device="cpu")
    assert lu0.device_lu.panels[0][0].dim() == 1
    assert lu1.device_lu.panels[0][0].dim() == 2
    assert not lu1.device_lu.panels[0][0].is_complex()
    assert np.max(np.abs(x1 - x0)) <= 1e-10 * np.max(np.abs(x0))


def test_cuda_wrappers_refuse_non_cuda_tensors():
    """A wrapper takes its plain version only for CPU tensors; any
    other device is refused before a kernel is looked up."""
    import torch
    from superlu_dist_tpu_torch.ops import _cuda
    with pytest.raises(ValueError):
        _cuda.require_cuda(torch.zeros(2, device="meta"),
                           (torch.float64,), "k")
