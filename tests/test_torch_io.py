"""The matrix readers (utils/io.py) against the JAX package's: the same
file, written under tmp_path, through both packages' `read_matrix`,
must give equal indptr, indices and data (dtype included)."""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp


def _both(path, **kw):
    from superlu_dist_tpu.utils.io import read_matrix as jread
    from superlu_dist_tpu_torch import read_matrix as tread
    aj, at = jread(path, **kw), tread(path, **kw)
    assert (at.m, at.n) == (aj.m, aj.n)
    assert np.array_equal(at.indptr, aj.indptr)
    assert np.array_equal(at.indices, aj.indices)
    assert at.data.dtype == aj.data.dtype
    assert np.array_equal(at.data, aj.data)
    return at


def _mats():
    from superlu_dist_tpu_torch.utils import testmat
    return testmat


# a 4×4 unsymmetric matrix in fixed-width fields that run together
# (one-digit row indices, and negative values that fill their field)
_HB_RUA = """\
run-together fields                                                     KEY1
             4             1             1             2
RUA                        4             4             8             0
(5I3)           (8I1)           (4E11.4)
  1  3  5  7  9
12233414
 4.0000E+00-1.0000E+00 4.5000E+00-2.2500E+00
 5.0000E+00-1.0000E-01-3.5000E+00 6.2500E+00
"""

# the symmetric tridiag(-1, 4, -1) of order 4, lower triangle stored
_RB_RSA = """\
symmetric RB                                                            KEY2
             3             1             1             1
rsa                        4             4             7             0
(5I3) (7I2) (7E11.4)
  1  3  5  7  8
 1 2 2 3 3 4 4
 4.0000E+00-1.0000E+00 4.0000E+00-1.0000E+00 4.0000E+00-1.0000E+00 4.0000E+00
"""


def test_hb_handwritten_run_together(tmp_path):
    p = tmp_path / "rt.rua"
    p.write_text(_HB_RUA)
    a = _both(str(p))
    dense = a.to_scipy().toarray()
    assert dense[1, 0] == -1.0 and dense[3, 3] == 6.25
    assert dense[0, 3] == -3.5 and a.nnz == 8


def test_rb_handwritten_symmetric(tmp_path):
    p = tmp_path / "sym.rb"
    p.write_text(_RB_RSA)
    a = _both(str(p))
    dense = a.to_scipy().toarray()
    assert np.array_equal(dense, dense.T) and a.nnz == 10
    assert dense[3, 2] == -1.0 and dense[3, 3] == 4.0


@pytest.mark.parametrize("signed", [False, True])
def test_hb_from_scipy_hb_write(tmp_path, signed):
    """scipy's hb_write declares (3E25.16) and writes 24-wide fields.
    With positive values the drift stays inside the fields' blanks and
    both packages read the file alike; with signed values the
    reference's width slicing cuts signs or joins fields (a fault of
    the reference, ROADMAP "Open items"), so the port is held to
    scipy's own reader there."""
    from superlu_dist_tpu_torch import read_matrix
    src = _mats().convection_diffusion_2d(12).to_scipy()
    if not signed:
        src = abs(src)
    p = tmp_path / "cd12.rua"
    scipy.io.hb_write(str(p), src.tocsc())
    a = read_matrix(str(p)) if signed else _both(str(p))
    ref = scipy.io.hb_read(str(p)).tocsr()
    assert a.nnz == ref.nnz and (a.to_scipy() != ref).nnz == 0
    assert abs(a.to_scipy() - src).max() <= 1e-15 * abs(src).max()


@pytest.mark.parametrize("kind", ["general", "symmetric",
                                  "skew-symmetric", "complex"])
def test_matrix_market(tmp_path, kind):
    tm = _mats()
    if kind == "complex":
        src, symm = tm.helmholtz_2d(5).to_scipy(), "general"
    elif kind == "general":
        src, symm = tm.random_unsymmetric(60, density=0.05).to_scipy(), kind
    elif kind == "symmetric":
        src, symm = tm.laplacian_2d(6).to_scipy(), kind
    else:
        r = tm.random_unsymmetric(40, density=0.08).to_scipy()
        src, symm = (r - r.T).tocsr(), kind
    p = tmp_path / f"{kind}.mtx"
    scipy.io.mmwrite(str(p), src, symmetry=symm)
    assert kind.split("-")[0] in p.read_text().splitlines()[0] or \
        kind == "complex"
    a = _both(str(p))
    assert a.data.dtype == (np.complex128 if kind == "complex"
                            else np.float64)
    assert abs(a.to_scipy() - src).max() <= 1e-14 * abs(src).max()


@pytest.mark.parametrize("header", [True, False])
def test_triples(tmp_path, header):
    src = sp.coo_matrix(_mats().random_unsymmetric(50, density=0.06)
                        .to_scipy())
    rows, cols = src.row + 1, src.col + 1
    p = tmp_path / ("t.dat" if header else "t.datnh")
    with open(p, "w") as f:
        if header:
            f.write(f"{src.shape[0]} {src.shape[1]} {src.nnz}\n")
        np.savetxt(f, np.column_stack([rows, cols, src.data]),
                   fmt=["%d", "%d", "%.17g"])
    a = _both(str(p))
    assert a.n == 50 or not header
    assert abs(a.to_scipy() - src.tocsr()[:a.m, :a.n]).max() == 0.0


@pytest.mark.parametrize("index_dtype,value", [
    (np.int32, "float64"), (np.int64, "float64"),
    (np.int32, "float32"), (np.int64, "complex128")])
def test_binary(tmp_path, index_dtype, value):
    """Written by both packages' write_binary (the same bytes), read
    with the value width inferred from the file size."""
    from superlu_dist_tpu.utils.io import write_binary as jwrite
    from superlu_dist_tpu_torch.utils.io import write_binary as twrite
    tm = _mats()
    src = (tm.helmholtz_2d(5) if value == "complex128"
           else tm.convection_diffusion_2d(8))
    src.data = src.data.astype(value)
    pt, pj = tmp_path / "t.bin", tmp_path / "j.bin"
    twrite(str(pt), src, index_dtype=index_dtype)
    jwrite(str(pj), src, index_dtype=index_dtype)
    assert pt.read_bytes() == pj.read_bytes()
    a = _both(str(pt), index_dtype=index_dtype)
    assert a.data.dtype == np.dtype(value)
    assert abs(a.to_scipy() - src.to_scipy()).max() == 0.0


def test_unknown_postfix_raises(tmp_path):
    from superlu_dist_tpu.utils.io import read_matrix as jread
    from superlu_dist_tpu_torch import read_matrix as tread
    p = tmp_path / "a.xyz"
    p.write_text("1 1 1\n1 1 1.0\n")
    for read in (jread, tread):
        with pytest.raises(ValueError, match="postfix"):
            read(str(p))


def test_atomic_write_bytes(tmp_path):
    from superlu_dist_tpu_torch.utils.io import atomic_write_bytes
    p = tmp_path / "store.bin"
    atomic_write_bytes(str(p), b"old")
    atomic_write_bytes(str(p), b"new content")
    assert p.read_bytes() == b"new content"
    assert os.listdir(tmp_path) == ["store.bin"]
    # a failing write leaves the old content and no tmp file
    with pytest.raises(TypeError):
        atomic_write_bytes(str(p), "not bytes")
    assert p.read_bytes() == b"new content"
    assert os.listdir(tmp_path) == ["store.bin"]
