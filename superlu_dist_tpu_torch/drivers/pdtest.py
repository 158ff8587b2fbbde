"""pdtest — option cross-product sweep (TEST/pdtest.c:96 analog).

The reference sweeps equilibration × row perms × Fact reuse modes ×
nrhs over CTest grid shapes (TEST/CMakeLists.txt:9-19), calling pdgssvx
twice (prefactor then test) and checking the scaled residual
‖B−AX‖/(‖A‖·‖X‖·eps) plus berr.  This driver does the same sweep over
backends and options; tests/test_torch_drivers.py runs a reduced
matrix of it on the CPU.

    python -m superlu_dist_tpu_torch.drivers.pdtest              # built-in 5pt, on the card
    python -m superlu_dist_tpu_torch.drivers.pdtest --device cpu g20.rua
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from .. import Fact, Options, gssvx
from ..options import ColPerm, IterRefine, RowPerm
from ..sparse import CSRMatrix
from ..utils.stats import Stats


def resid_check(a: CSRMatrix, x: np.ndarray, b: np.ndarray,
                eps: float) -> float:
    """pdcompute_resid (TEST/pdcompute_resid.c:33):
    ‖B−AX‖ / (‖A‖·‖X‖·eps), inf norms."""
    asp = a.to_scipy()
    r = b - asp @ x
    anorm = np.max(np.abs(asp).sum(axis=1))
    xnorm = np.max(np.sum(np.abs(x), axis=0))
    if anorm * xnorm == 0:
        return np.inf
    return float(np.max(np.abs(r)) / (anorm * xnorm * eps))


def run_case(a, b, opts, backend, lu_prev=None, device=None):
    x, lu, stats = gssvx(opts, a, b, stats=Stats(), backend=backend,
                         lu=lu_prev, device=device)
    return x, lu, stats


def sweep(a: CSRMatrix, backends=("host", "torch"),
          equils=(True, False),
          rowperms=(RowPerm.LARGE_DIAG_MC64, RowPerm.NOROWPERM),
          colperms=(ColPerm.METIS_AT_PLUS_A,),
          refines=(IterRefine.SLU_DOUBLE,),
          dtypes=("float64", "float32"),
          nrhss=(1, 3),
          resid_tol: float = 100.0,
          verbose: bool = True, device=None):
    """Returns (ncases, failures:list).  Each case exercises DOFACT,
    then SamePattern, SamePattern_SameRowPerm and FACTORED reuse on the
    same handle (the pdtest double-call pattern).  `device` is the
    torch backend's (None: the CUDA card)."""
    rng = np.random.default_rng(0)
    failures = []
    ncase = 0
    for (be, eq, rp, cp, ir, fdt, nrhs) in itertools.product(
            backends, equils, rowperms, colperms, refines, dtypes,
            nrhss):
        ncase += 1
        xtrue = rng.standard_normal((a.n, nrhs))
        b = a.to_scipy() @ xtrue
        eps = float(np.finfo(np.float64).eps)
        tag = (f"be={be} equil={eq} rowperm={rp.name} "
               f"colperm={cp.name} refine={ir.name} dtype={fdt} "
               f"nrhs={nrhs}")
        try:
            opts = Options(equil=eq, row_perm=rp, col_perm=cp,
                           iter_refine=ir, factor_dtype=fdt)
            x, lu, stats = run_case(a, b, opts, be, device=device)
            checks = [("DOFACT", x)]
            # value-refresh rungs on the same handle
            for fact in (Fact.SAME_PATTERN,
                         Fact.SAME_PATTERN_SAME_ROWPERM,
                         Fact.FACTORED):
                o2 = opts.replace(fact=fact)
                x2, lu, _ = run_case(a, b, o2, be, lu_prev=lu,
                                     device=device)
                checks.append((fact.name, x2))
            for name, xv in checks:
                r = resid_check(a, xv, b, eps)
                if not (r < resid_tol):
                    failures.append((tag, name, r))
                    if verbose:
                        print(f"FAIL {tag} [{name}] resid={r:.1f}")
        except Exception as e:  # noqa: BLE001 — sweep must report, not die
            failures.append((tag, "exception", repr(e)))
            if verbose:
                print(f"ERROR {tag}: {e!r}")
    return ncase, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pdtest", description="option cross-product sweep")
    p.add_argument("matrix", nargs="?", default=None,
                   help="matrix file (default: laplacian_2d(10))")
    p.add_argument("--device", default=None,
                   help="the torch backend's device (default: the CUDA "
                        "card)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.matrix:
        from ..utils.io import read_matrix
        a = read_matrix(args.matrix)
    else:
        from ..utils.testmat import laplacian_2d
        a = laplacian_2d(10)
    ncase, failures = sweep(a, device=args.device)
    print(f"pdtest: {ncase} cases x 4 reuse rungs, "
          f"{len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
