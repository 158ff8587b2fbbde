"""Sparse matrix containers.

Analog of the reference's matrix formats
(SRC/supermatrix.h:22-217).  The reference's tagged-union `SuperMatrix`
with SLU_NC/NR/SC/NR_loc storage collapses to one host-side CSR
container (`CSRMatrix`, the NRformat_loc analog) plus device-side COO
component arrays used by the SpMV kernel.  Distribution metadata
(NRformat_loc's fst_row/m_loc) is carried by the mesh sharding of the
device arrays instead of explicit fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR: the distributed-input format analog of
    NRformat_loc (SRC/supermatrix.h:176-188)."""

    m: int
    n: int
    indptr: np.ndarray   # (m+1,) int64
    indices: np.ndarray  # (nnz,) int64, column indices
    data: np.ndarray     # (nnz,) values

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def dtype(self):
        return self.data.dtype

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.m, self.n))

    def to_coo(self):
        rows = np.repeat(np.arange(self.m, dtype=np.int64),
                         np.diff(self.indptr))
        return rows, self.indices.astype(np.int64), self.data

    def transpose(self) -> "CSRMatrix":
        return csr_from_scipy(self.to_scipy().T.tocsr())


def csr_from_scipy(a) -> CSRMatrix:
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return CSRMatrix(
        m=a.shape[0],
        n=a.shape[1],
        indptr=np.asarray(a.indptr, dtype=np.int64),
        indices=np.asarray(a.indices, dtype=np.int64),
        data=np.asarray(a.data),
    )


def csr_from_coo(m: int, n: int, rows, cols, vals) -> CSRMatrix:
    import scipy.sparse as sp

    return csr_from_scipy(
        sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr())


