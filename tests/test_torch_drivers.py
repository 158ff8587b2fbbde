"""The command-line drivers (drivers/pddrive.py, drivers/pdtest.py)
against the JAX package's, on the same matrix file (laplacian_2d(9)
written as .bin under a temporary directory): the reference with its
host backend and with its default, the port on the CPU with each
backend and the fused solver."""

import os
import re

import pytest

_REF_RUNS = {}


@pytest.fixture(scope="module")
def matfile(tmp_path_factory):
    from superlu_dist_tpu_torch.utils.io import write_binary
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    p = tmp_path_factory.mktemp("mats") / "lap9.bin"
    write_binary(str(p), laplacian_2d(9))
    return str(p)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _numbers(out):
    err = float(re.search(r"inf-norm error: (\S+)", out).group(1))
    res = float(re.search(r"relative residual: (\S+)", out).group(1))
    return err, res


def _ref(matfile, backend, capsys):
    """The reference's pddrive on the file (once per backend)."""
    if backend not in _REF_RUNS:
        from superlu_dist_tpu.drivers import pddrive as jdrive
        argv = [matfile, "-s", "2"] + (["--backend", backend]
                                       if backend else [])
        rc, out, _ = _run(jdrive.main, argv, capsys)
        assert rc == 0
        _REF_RUNS[backend] = _numbers(out)
    return _REF_RUNS[backend]


@pytest.mark.parametrize("flags,ref_backend", [
    (["--backend", "host"], "host"),
    (["--device", "cpu"], None),
    (["--device", "cpu", "--backend", "torch"], None),
    (["--device", "cpu", "--fused", "--dtype", "float32", "-q"], None),
])
def test_pddrive_matches_reference(matfile, capsys, flags, ref_backend):
    from superlu_dist_tpu_torch.drivers import pddrive
    ref_err, _ = _ref(matfile, ref_backend, capsys)
    rc, out, _ = _run(pddrive.main, [matfile, "-s", "2"] + flags, capsys)
    assert rc == 0
    err, res = _numbers(out)
    assert err <= max(10 * ref_err, 1e-12)
    assert res < 1e-14
    if "-q" not in flags:
        assert "** Phase breakdown **" in out
        assert "matrix: " in out and "n=81" in out


def test_pddrive_verbose_matches_reference_describe(matfile, capsys):
    """The -v block equals the reference's Options.describe() for the
    same command line, less the lines of the reference's fields the port
    does not have (distribution and statistics knobs)."""
    from superlu_dist_tpu.drivers import pddrive as jdrive
    from superlu_dist_tpu_torch.drivers import pddrive
    argv = [matfile, "-v", "-q", "--colperm", "MMD_AT_PLUS_A"]
    _, jout, _ = _run(jdrive.main, argv + ["--backend", "host"], capsys)
    _, tout, _ = _run(pddrive.main, argv + ["--backend", "host"], capsys)

    def block(out):
        lines = out.splitlines()
        i = lines.index("** Options **")
        j = next(k for k in range(i + 1, len(lines))
                 if not lines[k].startswith("  "))
        return lines[i:j]

    jb, tb = block(jout), block(tout)
    only_ref = [ln for ln in jb if ln not in tb]
    assert [ln.split()[0] for ln in only_ref] == [
        "print_stat", "algo3d", "mesh_shape"]
    assert tb == [ln for ln in jb if ln not in only_ref]


@pytest.mark.parametrize("argv,item", [
    (["-r", "2", "--device", "cpu"], "item 15"),
    (["--stats", "--device", "cpu"], "item 15"),
    (["COMPLEX", "--device", "cpu"], "item 10"),
])
def test_pddrive_refusals_name_their_item(matfile, tmp_path, capsys,
                                          monkeypatch, argv, item):
    """Multi-GPU flags name item 15.  A complex file runs natively, and
    under SLU_COMPLEX_PAIR=1 on pair storage (item 10, 10b), which the
    output names: exit 0, error and residual at rounding level."""
    import scipy.io
    from superlu_dist_tpu_torch.drivers import pddrive
    from superlu_dist_tpu_torch.utils.testmat import helmholtz_2d
    if argv[0] == "COMPLEX":
        monkeypatch.setenv("SLU_COMPLEX_PAIR", "1")
        p = tmp_path / "h.mtx"
        scipy.io.mmwrite(str(p), helmholtz_2d(4).to_scipy())
        rc, out, err = _run(pddrive.main, [str(p)] + argv[1:], capsys)
        assert rc == 0 and "Traceback" not in err
        assert "complex storage: pair planes" in out
        e, r = _numbers(out)
        assert e <= 1e-10 and r <= 1e-13
        return
    argv = [matfile] + argv
    rc, out, err = _run(pddrive.main, argv, capsys)
    assert rc != 0
    assert item in err and "Traceback" not in err
    assert "inf-norm error" not in out


def test_pddrive_without_card_refuses(matfile, capsys, monkeypatch):
    """No card and no --device cpu: the no-device message, nothing
    solved; --backend host still runs."""
    import torch
    from superlu_dist_tpu_torch.drivers import pddrive
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(pddrive.main, [matfile], capsys)
    assert rc != 0 and "no CUDA device" in err and out == ""
    rc, out, _ = _run(pddrive.main, [matfile, "--backend", "host", "-q"],
                      capsys)
    assert rc == 0 and "relative residual" in out


def test_pddrive_leaves_environment_and_writes_profile(matfile, tmp_path,
                                                       capsys, monkeypatch):
    """main writes nothing to os.environ, with or without --profile.
    torch's profiler sets TORCHINDUCTOR_CACHE_DIR the first time it
    profiles in a process (a module it imports lazily does), so the
    variable is set through monkeypatch, which puts it back as it was,
    and one profile runs before the snapshot."""
    import torch
    from superlu_dist_tpu_torch.drivers import pddrive
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
    with torch.profiler.profile():
        torch.ones(2).sum()
    before = dict(os.environ)
    prof = tmp_path / "prof"
    for extra in ([], ["--profile", str(prof)]):
        rc, _, _ = _run(pddrive.main, [matfile, "--device", "cpu",
                                       "--trans", "TRANS", "-q"] + extra,
                        capsys)
        assert rc == 0
        assert dict(os.environ) == before
    assert os.listdir(prof) == ["pddrive_trace.json"]


def test_pdtest_sweep_reduced_matches_reference():
    """tests/test_drivers.py's reduced sweep (host backend) in both
    packages: the same case count, no failures."""
    from superlu_dist_tpu.drivers import pdtest as jtest
    from superlu_dist_tpu.utils.testmat import laplacian_2d as jlap
    from superlu_dist_tpu_torch.drivers import pdtest
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    kw = dict(backends=("host",), dtypes=("float64", "float32"),
              nrhss=(1, 2), verbose=False)
    nj, fj = jtest.sweep(jlap(7), **kw)
    nt, ft = pdtest.sweep(laplacian_2d(7), device="cpu", **kw)
    assert nt == nj == 16
    assert ft == fj == []


def test_pdtest_sweep_torch_backend():
    from superlu_dist_tpu_torch.drivers import pdtest
    from superlu_dist_tpu_torch.options import RowPerm
    from superlu_dist_tpu_torch.utils.testmat import laplacian_2d
    ncase, failures = pdtest.sweep(
        laplacian_2d(6), backends=("torch",), equils=(True, False),
        rowperms=(RowPerm.LARGE_DIAG_MC64,), dtypes=("float64",
                                                     "float32"),
        nrhss=(1,), verbose=False, device="cpu")
    assert ncase == 4
    assert failures == []
