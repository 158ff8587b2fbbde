"""Sparse matrix file I/O.

Analog of the reference's per-precision reader family
(SRC/dreadhb.c Harwell-Boeing, SRC/dreadrb.c Rutherford-Boeing,
SRC/dreadMM.c MatrixMarket, SRC/dreadtriple.c / dreadtriple_noheader.c
triples, SRC/dbinary_io.c raw binary) and the postfix dispatcher
`dcreate_matrix_postfix` (EXAMPLE/dcreate_matrix.c).  One
dtype-polymorphic implementation replaces the s/d/z triplication; all
readers return a `CSRMatrix`, complex ones included (a `.cua` file
reads as complex128), and the solver takes complex systems natively.

Formats:
  .rua/.rsa/.rra/.cua/.csa/.cra  Harwell-Boeing (type from header)
  .rb                            Rutherford-Boeing
  .mtx                           MatrixMarket coordinate
  .dat                           triples with "m n nnz" header line
  .datnh                         triples without header (1-based)
  .bin                           raw binary CSC dump (n, nnz, colptr,
                                 rowind, values), int32 or int64
                                 indices — layout-compatible with the
                                 reference's dread_binary/dwrite_binary
                                 (SRC/dbinary_io.c:4,24)
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import scipy.sparse as sp

from ..sparse import CSRMatrix, csr_from_scipy


# --------------------------------------------------------------------
# Fortran fixed-format parsing (HB/RB headers carry e.g. (16I5),
# (5E15.8), (1P,4D20.12) — fields may run together, so slice by width)
# --------------------------------------------------------------------

_FMT_RE = re.compile(
    r"\(\s*(?:\d+\s*P\s*,?\s*)?(?:(\d+)\s*\(\s*)?(\d*)\s*([IEDFG])"
    r"\s*(\d+)(?:\.\d+)?", re.IGNORECASE)


def _parse_fortran_format(fmt: str):
    """Return (per_line_count, field_width, kind) from a Fortran format
    string.  kind is 'int' or 'float'."""
    m = _FMT_RE.search(fmt)
    if not m:
        raise ValueError(f"unparseable Fortran format: {fmt!r}")
    outer, rep, letter, width = m.groups()
    count = int(rep) if rep else 1
    if outer:
        count *= int(outer)
    kind = "int" if letter.upper() == "I" else "float"
    return count, int(width), kind


def _read_fixed(lines_iter, total: int, count: int, width: int,
                kind: str) -> np.ndarray:
    """Read `total` fields laid out `count` per line, `width` wide.  A
    line that splits on whitespace into exactly the fields it should
    hold is read by its tokens; any other line is sliced by width
    (fields that run together).  The token path is where this reader
    parts from the reference's, which always slices: scipy's
    `hb_write` declares (3E25.16) and writes 24-wide fields, and
    slicing those by 25 shifts each later field by a character, which
    cuts off a minus sign (a silently wrong value) or joins two fields
    (an error)."""
    out = np.empty(total, dtype=np.int64 if kind == "int" else np.float64)

    def conv(t):
        return (int(t) if kind == "int"
                else float(t.replace("D", "E").replace("d", "e")))

    got = 0
    while got < total:
        line = next(lines_iter).rstrip("\n")
        take = min(count, total - got)
        toks = line.split()
        if len(toks) == take:
            for t in toks:
                out[got] = conv(t)
                got += 1
            continue
        for i in range(take):
            s = line[i * width:(i + 1) * width].strip()
            if not s:
                # short line: fall back to whitespace splitting for the
                # remainder of this line
                for t in line[i * width:].split():
                    if got >= total:
                        break
                    out[got] = conv(t)
                    got += 1
                break
            out[got] = conv(s)
            got += 1
    return out


# --------------------------------------------------------------------
# Harwell-Boeing / Rutherford-Boeing
# --------------------------------------------------------------------

def _assemble_hb(mxtype: str, nrow: int, ncol: int, nnz: int,
                 colptr: np.ndarray, rowind: np.ndarray,
                 values: np.ndarray | None) -> CSRMatrix:
    vtype, symm = mxtype[0].upper(), mxtype[1].upper()
    if vtype == "C":
        values = values[0::2] + 1j * values[1::2]
    elif vtype == "P" or values is None:
        values = np.ones(nnz)
    a = sp.csc_matrix((values, rowind - 1, colptr - 1),
                      shape=(nrow, ncol))
    if symm == "S":        # symmetric: lower triangle stored
        a = a + a.T - sp.diags(a.diagonal())
    elif symm == "Z":      # skew-symmetric
        a = a - a.T
    elif symm == "H":      # hermitian
        a = a + a.conj().T - sp.diags(a.diagonal())
    return csr_from_scipy(a.tocsr())


def read_hb(path: str) -> CSRMatrix:
    """Harwell-Boeing reader (dreadhb.c analog)."""
    with open(path) as f:
        lines = iter(f.readlines())
    next(lines)                                  # title + key
    card2 = next(lines)
    totcrd = card2.split()
    rhscrd = int(totcrd[4]) if len(totcrd) >= 5 else 0
    card3 = next(lines).split()
    mxtype = card3[0]
    nrow, ncol, nnz = int(card3[1]), int(card3[2]), int(card3[3])
    card4 = next(lines)
    ptrfmt = card4[0:16]
    indfmt = card4[16:32]
    valfmt = card4[32:52]
    if rhscrd > 0:
        next(lines)                              # RHS type card, unused

    pc, pw, _ = _parse_fortran_format(ptrfmt)
    ic, iw, _ = _parse_fortran_format(indfmt)
    colptr = _read_fixed(lines, ncol + 1, pc, pw, "int")
    rowind = _read_fixed(lines, nnz, ic, iw, "int")
    values = None
    if mxtype[0].upper() != "P":
        vc, vw, _ = _parse_fortran_format(valfmt)
        nval = 2 * nnz if mxtype[0].upper() == "C" else nnz
        values = _read_fixed(lines, nval, vc, vw, "float")
    return _assemble_hb(mxtype, nrow, ncol, nnz, colptr, rowind, values)


def read_rb(path: str) -> CSRMatrix:
    """Rutherford-Boeing reader (dreadrb.c analog).  RB is HB without
    the RHS card and with a 4-integer second card."""
    with open(path) as f:
        lines = iter(f.readlines())
    next(lines)
    next(lines)                                  # totcrd ptrcrd indcrd valcrd
    card3 = next(lines).split()
    mxtype = card3[0]
    nrow, ncol, nnz = int(card3[1]), int(card3[2]), int(card3[3])
    card4 = next(lines)
    parts = card4.split()
    ptrfmt, indfmt = parts[0], parts[1]
    valfmt = parts[2] if len(parts) > 2 else "(5E15.8)"
    pc, pw, _ = _parse_fortran_format(ptrfmt)
    ic, iw, _ = _parse_fortran_format(indfmt)
    colptr = _read_fixed(lines, ncol + 1, pc, pw, "int")
    rowind = _read_fixed(lines, nnz, ic, iw, "int")
    values = None
    if mxtype[0].lower() != "p":
        vc, vw, _ = _parse_fortran_format(valfmt)
        nval = 2 * nnz if mxtype[0].lower() == "c" else nnz
        values = _read_fixed(lines, nval, vc, vw, "float")
    return _assemble_hb(mxtype, nrow, ncol, nnz, colptr, rowind, values)


# --------------------------------------------------------------------
# MatrixMarket (dreadMM.c analog)
# --------------------------------------------------------------------

def read_mm(path: str) -> CSRMatrix:
    with open(path) as f:
        header = f.readline().split()
        if (len(header) < 5 or header[0] != "%%MatrixMarket"
                or header[1].lower() != "matrix"
                or header[2].lower() != "coordinate"):
            raise ValueError(
                f"{path}: only MatrixMarket coordinate format supported")
        field = header[3].lower()     # real/complex/integer/pattern
        symm = header[4].lower()      # general/symmetric/skew-symmetric/hermitian
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(t) for t in line.split())
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        cplx = field == "complex"
        vals = np.empty(nnz, dtype=np.complex128 if cplx else np.float64)
        k = 0
        for line in f:
            t = line.split()
            if not t:
                continue
            rows[k] = int(t[0]); cols[k] = int(t[1])
            if field == "pattern":
                vals[k] = 1.0
            elif cplx:
                vals[k] = float(t[2]) + 1j * float(t[3])
            else:
                vals[k] = float(t[2])
            k += 1
        if k != nnz:
            raise ValueError(f"{path}: expected {nnz} entries, got {k}")
    rows -= 1
    cols -= 1
    a = sp.coo_matrix((vals, (rows, cols)), shape=(nrow, ncol))
    if symm in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sv = vals[off]
        if symm == "skew-symmetric":
            sv = -sv
        elif symm == "hermitian":
            sv = np.conj(sv)
        a = a + sp.coo_matrix((sv, (cols[off], rows[off])),
                              shape=(nrow, ncol))
    return csr_from_scipy(a.tocsr())


# --------------------------------------------------------------------
# Triples (dreadtriple.c / dreadtriple_noheader.c analogs)
# --------------------------------------------------------------------

def read_triples(path: str) -> CSRMatrix:
    """Header line `m n nnz`, then `row col value` triples.  Base is
    auto-detected: any 0 index → 0-based, else 1-based (the reference
    probes the same way, SRC/dreadtriple_noheader.c)."""
    with open(path) as f:
        m, n, nnz = (int(t) for t in f.readline().split())
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    return _triples_to_csr(m, n, nnz, data, path)


def read_triples_noheader(path: str) -> CSRMatrix:
    with open(path) as f:
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    n = int(max(rows.max(), cols.max()))
    zero_based = rows.min() == 0 or cols.min() == 0
    if zero_based:
        n += 1
    return _triples_to_csr(n, n, len(rows), data, path)


def _triples_to_csr(m, n, nnz, data, path) -> CSRMatrix:
    if data.shape[0] != nnz:
        raise ValueError(f"{path}: header says {nnz} triples, "
                         f"file has {data.shape[0]}")
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    if data.shape[1] >= 4:        # complex triples: row col re im
        vals = data[:, 2] + 1j * data[:, 3]
    else:
        vals = data[:, 2]
    if rows.min(initial=1) > 0 and cols.min(initial=1) > 0:
        rows -= 1
        cols -= 1
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    return csr_from_scipy(a.tocsr())


# --------------------------------------------------------------------
# Raw binary (dbinary_io.c-compatible CSC dump)
# --------------------------------------------------------------------

def read_binary(path: str, index_dtype=np.int32,
                value_dtype=None) -> CSRMatrix:
    """Layout: n, nnz (index_dtype), colptr[n+1], rowind[nnz]
    (index_dtype, 0-based), values[nnz] (value_dtype) — matching the
    reference's dread_binary (SRC/dbinary_io.c:4; int_t is int32 unless
    built with XSDK_INDEX_SIZE=64, hence the index_dtype knob).

    value_dtype=None infers the value width from the file size (the
    format carries no dtype tag): 4 → float32, 8 → float64,
    16 → complex128."""
    idt = np.dtype(index_dtype)
    with open(path, "rb") as f:
        hdr = np.fromfile(f, dtype=idt, count=2)
        n, nnz = int(hdr[0]), int(hdr[1])
        if value_dtype is None:
            vbytes = ((os.path.getsize(path)
                       - (n + 3 + nnz) * idt.itemsize) // max(nnz, 1))
            value_dtype = {4: np.float32, 8: np.float64,
                           16: np.complex128}.get(int(vbytes))
            if value_dtype is None:
                raise ValueError(
                    f"{path}: cannot infer value dtype "
                    f"({vbytes} bytes/value); pass value_dtype=")
        colptr = np.fromfile(f, dtype=idt, count=n + 1)
        rowind = np.fromfile(f, dtype=idt, count=nnz)
        values = np.fromfile(f, dtype=np.dtype(value_dtype), count=nnz)
    a = sp.csc_matrix((values, rowind.astype(np.int64),
                       colptr.astype(np.int64)), shape=(n, n))
    return csr_from_scipy(a.tocsr())


def write_binary(path: str, a: CSRMatrix, index_dtype=np.int32) -> None:
    """dwrite_binary analog (SRC/dbinary_io.c:24)."""
    idt = np.dtype(index_dtype)
    acsc = a.to_scipy().tocsc()
    acsc.sort_indices()
    with open(path, "wb") as f:
        np.asarray([a.n, acsc.nnz], dtype=idt).tofile(f)
        acsc.indptr.astype(idt).tofile(f)
        acsc.indices.astype(idt).tofile(f)
        np.asarray(acsc.data).tofile(f)


# --------------------------------------------------------------------
# Crash-safe writes (the durability primitive of the factor store,
# ROADMAP queue 1 item 14)
# --------------------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` atomically: a reader (or a post-crash
    restart) sees either the old content or the complete new content,
    never a torn write.  Standard tmp-file + fsync + rename in the
    destination directory (os.replace is atomic within a filesystem).

    The tmp name carries the writer's PID on top of mkstemp's own
    O_EXCL random suffix: two REPLICA PROCESSES racing a write to one
    shared-store path each stage into their own tmp file (never
    interleaving bytes), and a crash's leftover tmp litter names the
    process that leaked it."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=f".tmp-{os.getpid():x}-",
                               suffix=os.path.basename(path), dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# --------------------------------------------------------------------
# Postfix dispatch (dcreate_matrix_postfix analog)
# --------------------------------------------------------------------

_HB_EXTS = (".rua", ".rsa", ".rra", ".rza", ".cua", ".csa", ".cra",
            ".cza", ".pua", ".psa")


def read_matrix(path: str, **kw) -> CSRMatrix:
    """Dispatch on filename postfix like the reference's
    dcreate_matrix_postfix (EXAMPLE/dcreate_matrix.c): .rua/.cua → HB,
    .rb → RB, .mtx → MatrixMarket, .dat → triples, .datnh → headerless
    triples, .bin → binary."""
    low = path.lower()
    if any(low.endswith(e) for e in _HB_EXTS):
        return read_hb(path)
    if low.endswith(".rb"):
        return read_rb(path)
    if low.endswith(".mtx"):
        return read_mm(path)
    if low.endswith(".datnh"):
        return read_triples_noheader(path)
    if low.endswith(".dat") or low.endswith(".triple"):
        return read_triples(path)
    if low.endswith(".bin"):
        return read_binary(path, **kw)
    raise ValueError(f"unrecognized matrix file postfix: {path}")
