"""Sparse matrix containers (port of `lanczos_tpu/ops/formats.py`).

ELL / COO / CSR / BSR / DIA as `nn.Module`s whose arrays are registered
buffers.  The JAX package computes all of them in XLA (gathers, segment
sums, einsums, shifted slices), not in Pallas, so here they are plain
torch: `segment_sum` becomes `index_add_`, the gathers `index_select`.
The windowed-ELL layout, whose SpMM is the hand-written kernel K8, is
`ops/window_ell.py`; `BsrWindowedOperator` puts a BSR face on it.

Padding convention, as in JAX: padded slots (and the padded rows of
arrays taken from JAX) carry value 0 and column index 0, so their
gathered products contribute exactly zero.  The builders here size their
buffers at exactly n rows and nnz entries (at least 1).
Builders put their buffers on `device` (default "cuda"; without a card
that default raises, see `ops/operator.target_device`).  Every container
also has `from_arrays`, which takes the JAX container's arrays as NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import LinearOperator, target_device

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _as_2d_scipy(a):
    import scipy.sparse as sp

    if not sp.issparse(a):
        a = sp.csr_matrix(np.asarray(a))
    return a


def np_dtype(dtype) -> np.dtype:
    """NumPy dtype of a torch (or NumPy) float dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def to_buffer(x, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` (copied if read-only)."""
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # e.g. a view of a JAX array
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


class EllMatrix(LinearOperator):
    """ELLPACK: row-major (n_rows, width) value/index planes (reference
    `Ell_matrix`, `ell_matrix.hpp:11`, at any width)."""

    def __init__(self, data: torch.Tensor, indices: torch.Tensor,
                 n_rows_true: int, n_cols_true: int):
        super().__init__()
        self.register_buffer("data", data)  # (n_rows, width)
        self.register_buffer("indices", indices)  # (n_rows, width) int32
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)

    @classmethod
    def from_arrays(cls, data, indices, n_rows_true, n_cols_true, *,
                    dtype=None, device="cuda") -> "EllMatrix":
        device = target_device(device)
        return cls(to_buffer(data, device, dtype),
                   to_buffer(np.asarray(indices, np.int32), device),
                   n_rows_true, n_cols_true)

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def padded_rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y[i] = sum_k data[i,k] * x[idx[i,k]] (reference `ell::SpMV`)."""
        gathered = x.index_select(0, self.indices.reshape(-1)).view(self.data.shape)
        return (self.data * gathered).sum(dim=1)[: self.n_rows_true]

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """Block-major X (p, n) -> (p, n_rows) (reference `ell::SpMM`)."""
        p = X.shape[0]
        gathered = X.index_select(1, self.indices.reshape(-1)).view(
            (p,) + tuple(self.data.shape))
        return (self.data * gathered).sum(dim=2)[:, : self.n_rows_true]

    def to_dense(self) -> torch.Tensor:
        rows = torch.arange(self.padded_rows, device=self.data.device)
        rows = rows[:, None].expand_as(self.indices)
        dense = torch.zeros((self.padded_rows, self.n_cols_true),
                            dtype=self.dtype, device=self.data.device)
        dense.index_put_((rows, self.indices.long()), self.data, accumulate=True)
        return dense[: self.n_rows_true]

    # -- diagonal helpers (reference `Ell_matrix::diag_inv/diag_sqrt/
    # mult_diagonal`, `ell_matrix.hpp:302-361`) ----------------------------

    def mult_diagonal(self, w: torch.Tensor) -> "EllMatrix":
        """A @ diag(w): scale column j by w[j] (the reference's
        symmetrization step A = D * W); indices unchanged."""
        scale = w.index_select(0, self.indices.reshape(-1)).view(self.data.shape)
        return EllMatrix(self.data * scale, self.indices, self.n_rows_true,
                         self.n_cols_true)

    def diagonal(self) -> torch.Tensor:
        """Main-diagonal entries (summing duplicates on the diagonal)."""
        rows = torch.arange(self.padded_rows, device=self.data.device)[:, None]
        on_diag = (self.indices == rows) & (rows < self.n_rows_true)
        return torch.where(on_diag, self.data, 0).sum(dim=1)[: self.n_rows_true]

    def diag_inv(self) -> torch.Tensor:
        """1/diag (reference `lm::diag_inv`; zeros stay zero)."""
        d = self.diagonal()
        return torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 0.0)

    def diag_sqrt(self) -> torch.Tensor:
        """sqrt(diag) (reference `lm::diag_sqrt`)."""
        return torch.sqrt(self.diagonal())


def ell_from_scipy(a, dtype=torch.float32, width: int | None = None,
                   device="cuda") -> EllMatrix:
    """Pack a scipy matrix into ELL, vectorised (the JAX package's NumPy
    fill, `formats.py:162-169`, without the per-row loop)."""
    device = target_device(device)
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    per_row = np.diff(a.indptr)
    w = int(per_row.max()) if width is None and n else (width or 1)
    w = max(w, 1)
    if n and int(per_row.max()) > w:
        raise ValueError(f"a row holds {int(per_row.max())} nonzeros, more "
                         f"than the ELL width {w}")
    data = np.zeros((n, w), np_dtype(dtype))
    idx = np.zeros((n, w), np.int32)
    rr = np.repeat(np.arange(n), per_row)
    kk = np.arange(a.nnz, dtype=np.int64) - np.repeat(
        a.indptr[:-1].astype(np.int64), per_row)
    data[rr, kk] = a.data
    idx[rr, kk] = a.indices
    return EllMatrix(to_buffer(data, device), to_buffer(idx, device), n, m)


# ---------------------------------------------------------------------------
# COO and CSR
# ---------------------------------------------------------------------------


def _segment_mm(data, rows, cols, X, n_rows):
    """sum over nonzeros of data * X[:, col] into row `row`: the gather +
    `segment_sum` of the JAX containers, as `index_add_`."""
    squeeze = X.ndim == 1
    if squeeze:
        X = X[None]
    prod = data[None, :] * X.index_select(1, cols)
    y = torch.zeros((X.shape[0], n_rows), dtype=prod.dtype, device=X.device)
    y.index_add_(1, rows, prod)
    return y[0] if squeeze else y


class CooMatrix(LinearOperator):
    """COO triplets, padded: padding entries carry data 0 at (0, 0)."""

    def __init__(self, rows, cols, data, n_rows_true: int, n_cols_true: int):
        super().__init__()
        self.register_buffer("rows", rows)  # (nnz,) int32
        self.register_buffer("cols", cols)  # (nnz,) int32
        self.register_buffer("data", data)  # (nnz,)
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)

    @classmethod
    def from_arrays(cls, rows, cols, data, n_rows_true, n_cols_true, *,
                    dtype=None, device="cuda") -> "CooMatrix":
        device = target_device(device)
        return cls(to_buffer(np.asarray(rows, np.int32), device),
                   to_buffer(np.asarray(cols, np.int32), device),
                   to_buffer(data, device, dtype), n_rows_true, n_cols_true)

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def mv(self, x):
        return _segment_mm(self.data, self.rows, self.cols, x, self.n_rows_true)

    def mm(self, X):
        return _segment_mm(self.data, self.rows, self.cols, X, self.n_rows_true)

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.data.device)
        dense.index_put_((self.rows.long(), self.cols.long()), self.data,
                         accumulate=True)
        return dense


def coo_from_scipy(a, dtype=torch.float32, device="cuda") -> CooMatrix:
    device = target_device(device)
    a = _as_2d_scipy(a).tocoo()
    a.sum_duplicates()
    n, m = a.shape
    nnz = a.nnz
    nnzp = max(nnz, 1)
    rows = np.zeros(nnzp, np.int32)
    cols = np.zeros(nnzp, np.int32)
    data = np.zeros(nnzp, np_dtype(dtype))
    rows[:nnz], cols[:nnz], data[:nnz] = a.row, a.col, a.data
    return CooMatrix(to_buffer(rows, device), to_buffer(cols, device),
                     to_buffer(data, device), n, m)


class CsrMatrix(LinearOperator):
    """CSR with an explicit row-id plane for the segment reduction; indptr
    is kept for interop."""

    def __init__(self, indptr, indices, data, row_ids, n_rows_true: int,
                 n_cols_true: int):
        super().__init__()
        self.register_buffer("indptr", indptr)  # (n_rows_true + 1,) int32
        self.register_buffer("indices", indices)  # (nnz,) int32
        self.register_buffer("data", data)  # (nnz,)
        self.register_buffer("row_ids", row_ids)  # (nnz,) int32
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)

    @classmethod
    def from_arrays(cls, indptr, indices, data, row_ids, n_rows_true,
                    n_cols_true, *, dtype=None, device="cuda") -> "CsrMatrix":
        device = target_device(device)
        i32 = [to_buffer(np.asarray(x, np.int32), device)
               for x in (indptr, indices, row_ids)]
        return cls(i32[0], i32[1], to_buffer(data, device, dtype), i32[2],
                   n_rows_true, n_cols_true)

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def mv(self, x):
        return _segment_mm(self.data, self.row_ids, self.indices, x,
                           self.n_rows_true)

    def mm(self, X):
        return _segment_mm(self.data, self.row_ids, self.indices, X,
                           self.n_rows_true)

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.data.device)
        dense.index_put_((self.row_ids.long(), self.indices.long()), self.data,
                         accumulate=True)
        return dense


def csr_from_scipy(a, dtype=torch.float32, device="cuda") -> CsrMatrix:
    device = target_device(device)
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    nnz = a.nnz
    nnzp = max(nnz, 1)
    indices = np.zeros(nnzp, np.int32)
    data = np.zeros(nnzp, np_dtype(dtype))
    row_ids = np.zeros(nnzp, np.int32)
    indices[:nnz], data[:nnz] = a.indices, a.data
    row_ids[:nnz] = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.indptr))
    return CsrMatrix(to_buffer(a.indptr.astype(np.int32), device),
                     to_buffer(indices, device), to_buffer(data, device),
                     to_buffer(row_ids, device), n, m)


# ---------------------------------------------------------------------------
# BSR
# ---------------------------------------------------------------------------


class BsrMatrix(LinearOperator):
    """Block-sparse rows in block-ELL layout: every block-row padded to w
    blocks (padding blocks: zero data at block-column 0), so y is a
    fixed-width sum over block slots; the block products are one einsum."""

    def __init__(self, data, block_cols, n_rows_true: int, n_cols_true: int):
        super().__init__()
        self.register_buffer("data", data)  # (nbr, w, bs, bs)
        self.register_buffer("block_cols", block_cols)  # (nbr, w) int32
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)

    @classmethod
    def from_arrays(cls, data, block_cols, n_rows_true, n_cols_true, *,
                    dtype=None, device="cuda") -> "BsrMatrix":
        device = target_device(device)
        return cls(to_buffer(data, device, dtype),
                   to_buffer(np.asarray(block_cols, np.int32), device),
                   n_rows_true, n_cols_true)

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def block_size(self) -> int:
        return self.data.shape[2]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    def mv(self, x):
        return self.mm(x[None, :])[0]

    def mm(self, X):
        bs = self.block_size
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None, :]
        p = X.shape[0]
        Xb = torch.nn.functional.pad(X, (0, (-X.shape[1]) % bs)).reshape(p, -1, bs)
        nbr, w = self.block_cols.shape
        gathered = Xb.index_select(1, self.block_cols.reshape(-1)).view(p, nbr, w, bs)
        Yb = torch.einsum("rwij,prwj->pri", self.data, gathered)
        out = Yb.reshape(p, -1)[:, : self.n_rows_true]
        return out[0] if squeeze else out

    def to_dense(self) -> torch.Tensor:
        bs = self.block_size
        nbr, w = self.block_cols.shape
        dev = self.data.device
        mpad = _round_up(self.n_cols_true, bs)
        rr = torch.arange(nbr, device=dev).repeat_interleave(w)
        cc = self.block_cols.reshape(-1).long()
        ar = torch.arange(bs, device=dev)
        row_idx = (rr * bs)[:, None, None] + ar[None, :, None]
        col_idx = (cc * bs)[:, None, None] + ar[None, None, :]
        dense = torch.zeros((nbr * bs, mpad), dtype=self.dtype, device=dev)
        dense.index_put_((row_idx.expand(-1, bs, bs), col_idx.expand(-1, bs, bs)),
                         self.data.reshape(-1, bs, bs), accumulate=True)
        return dense[: self.n_rows_true, : self.n_cols_true]


class BsrWindowedOperator(LinearOperator):
    """BSR face over the windowed-ELL SpMM (K8): a bs x bs block adds bs
    planes either way, so converting to the windowed layout is the fast
    path, and it packs the true nonzeros with no block fill-in.  A drop-in
    operator in the ORIGINAL row ordering (any internal RCM permutation is
    applied and undone at the call boundary)."""

    def __init__(self, base, bs: int):
        super().__init__()
        self.base = base  # WindowedEllMatrix
        self.bs = int(bs)

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def block_size(self) -> int:
        return self.bs

    @property
    def nnz(self) -> int:
        """TRUE stored nonzeros (no block fill-in)."""
        return self.base.nnz

    def mv(self, x):
        return self.mm(x[None, :])[0]

    def mm(self, X):
        y = self.base.mm(self.base.permute(X))
        return self.base.unpermute(y[..., : self.base.shape[0]])

    def to_dense(self) -> torch.Tensor:
        d = self.base.to_dense()  # P A P^T
        if self.base.is_permuted:
            inv = torch.argsort(self.base.perm)
            d = d[inv][:, inv]
        return d


def bsr_from_scipy(a, block_size: int = 8, dtype=torch.float32,
                   engine: str = "auto", device="cuda"):
    """engine='windowed': the windowed-ELL kernel behind a BSR face
    (`BsrWindowedOperator`); 'einsum': the gather + einsum `BsrMatrix`;
    'auto': windowed for float32, falling back to einsum when the plan
    fails, and einsum for float64 (the JAX package's rule: its windowed
    kernel accumulates in f32, so f64 keeps the exact einsum path)."""
    if engine not in ("auto", "windowed", "einsum"):
        raise ValueError(f"unknown engine={engine!r}")
    device = target_device(device)
    if engine == "auto" and np_dtype(dtype) != np.float32:
        engine = "einsum"
    if engine in ("auto", "windowed"):
        from lanczos_tpu_torch.ops.window_ell import PlanError, windowed_from_scipy

        try:
            base = windowed_from_scipy(
                _as_2d_scipy(a).tocsr().astype(np_dtype(dtype)), dtype=dtype,
                device=device)
            return BsrWindowedOperator(base, block_size)
        except PlanError:
            if engine == "windowed":
                raise
    return _bsr_einsum_from_scipy(a, block_size, dtype, device)


def _bsr_einsum_from_scipy(a, block_size, dtype, device) -> BsrMatrix:
    import scipy.sparse as sp

    a = _as_2d_scipy(a).tocsr()
    n, m = a.shape
    bs = block_size
    npad, mpad = _round_up(n, bs), _round_up(m, bs)
    if (npad, mpad) != (n, m):
        a = a.copy()
        a.resize((npad, mpad))
    ab = sp.bsr_matrix(a, blocksize=(bs, bs))
    ab.sum_duplicates()
    nbr = ab.indptr.shape[0] - 1
    per_row = np.diff(ab.indptr)
    w = max(int(per_row.max()) if nbr else 0, 1)
    data = np.zeros((nbr, w, bs, bs), np_dtype(dtype))
    cols = np.zeros((nbr, w), np.int32)
    rr = np.repeat(np.arange(nbr), per_row)
    kk = np.arange(len(ab.indices), dtype=np.int64) - np.repeat(
        ab.indptr[:-1].astype(np.int64), per_row)
    data[rr, kk] = ab.data
    cols[rr, kk] = ab.indices
    return BsrMatrix(to_buffer(data, device), to_buffer(cols, device), n, m)


# ---------------------------------------------------------------------------
# DIA — gather-free products by shifted slices
# ---------------------------------------------------------------------------


class DiaMatrix(LinearOperator):
    """Diagonal-offset storage: y = sum_d data[d] * shift(x, offsets[d]),
    each shift a slice of a zero-padded x (no gather)."""

    def __init__(self, data, offsets, n_rows_true: int, n_cols_true: int):
        super().__init__()
        self.register_buffer("data", data)  # (ndiag, n_rows)
        self.offsets = tuple(int(o) for o in offsets)
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)

    @classmethod
    def from_arrays(cls, data, offsets, n_rows_true, n_cols_true, *,
                    dtype=None, device="cuda") -> "DiaMatrix":
        device = target_device(device)
        return cls(to_buffer(data, device, dtype), offsets, n_rows_true,
                   n_cols_true)

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    def _halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def mv(self, x):
        return self.mm(x[None, :])[0]

    def mm(self, X):
        h = self._halo()
        npad = self.data.shape[1]
        p = X.shape[0]
        # columns past npad + h meet no row of the band
        cols = min(X.shape[1], npad + h)
        Xp = torch.zeros((p, npad + 2 * h), dtype=X.dtype, device=X.device)
        Xp[:, h : h + cols] = X[:, :cols]
        Y = torch.zeros((p, npad), dtype=X.dtype, device=X.device)
        for d, off in enumerate(self.offsets):
            Y = Y + self.data[d][None, :] * Xp[:, h + off : h + off + npad]
        return Y[:, : self.n_rows_true]

    def to_dense(self) -> torch.Tensor:
        n, m = self.shape
        dense = torch.zeros((n, m), dtype=self.dtype, device=self.data.device)
        rows = torch.arange(n, device=self.data.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < m)
            dense[rows[ok], cols[ok]] += self.data[d][:n][ok]
        return dense


def dia_from_scipy(a, dtype=torch.float32, device="cuda") -> DiaMatrix:
    device = target_device(device)
    a = _as_2d_scipy(a).tocoo()
    a.sum_duplicates()
    n, m = a.shape
    diag_of = a.col.astype(np.int64) - a.row.astype(np.int64)
    offs = np.unique(diag_of)
    data = np.zeros((len(offs), n), np_dtype(dtype))
    # entries are unique after sum_duplicates: one (diagonal, row) each
    data[np.searchsorted(offs, diag_of), a.row] = a.data
    return DiaMatrix(to_buffer(data, device), offs, n, m)
