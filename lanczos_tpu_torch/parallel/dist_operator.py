"""Row-sharded assembled-matrix operators (port of
`lanczos_tpu/parallel/dist_operator.py`).

The rows of the matrix and of every Krylov state are split over the ranks
of a 1-D mesh, rows_loc = round_up(ceil(n / n_dev), 8) a rank, rank r
holding rows [r rows_loc, (r + 1) rows_loc) of JAX's padded global state
(the last rank's rows past n are zero).  A state on a rank is (rows_loc,)
or block-major (p, rows_loc).

* `HaloShardedEll`, for banded matrices: each rank stores its rows as ELL
  whose columns are positions in its halo-extended window ``[halo |
  rows_loc local rows | halo]``.  A product is one halo exchange
  (`Mesh.halo_window`, JAX's ppermutes; k-hop when the halo is wider than
  a shard), then the local gather.  The halo is the matrix's global one,
  the same on every rank; `reorder="auto"` applies a symmetric RCM
  permutation when the natural order would need more than one hop.
* `GatherShardedEll`, for any sparsity: global columns, and a product
  all-gathers x first (O(n) communication a product).

The local product is plain torch (`index_select` and a sum over the ELL
width), as the JAX package's is XLA's `take` + `einsum`, not a Pallas
kernel.  Pad entries carry data 0, so the pad rows of every product are
exactly 0 and Grams over the padded state are the matrix's own.  Both
operators have `mesh`, so the Lanczos methods sum every reduction over
the ranks (see `methods/block_lanczos.py`) and read the receiver through
`storage_trace_fn`, the value at flat index i of JAX's padded (and, with
RCM, permuted) global state: pass `local_index(lc)` for a natural-order
receiver, as JAX's tests do.

`halo_shard` and `gather_shard` are pure host functions of the scipy
matrix, the mesh size and a rank, so one process can build every rank's
shard (the tests, `chip_smoke.py`); the builders call them for their own
rank.  The packer is the C++ engine (`native.halo_ell_from_csr`); its
NumPy version runs only with `packer="numpy"`.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_tpu_torch.ops.formats import _as_2d_scipy, _round_up, np_dtype, to_buffer
from lanczos_tpu_torch.ops.operator import LinearOperator
from lanczos_tpu_torch.parallel.mesh import Mesh

ROW_TILE = 8  # JAX's (lanczos_tpu/ops/formats.py:30): shards match JAX's row for row


def shard_rows(n: int, n_dev: int, tile: int = ROW_TILE) -> int:
    """rows_loc: the rows each of n_dev ranks holds, a multiple of `tile`
    (ROW_TILE for the ELL operators, 128 lanes for the windowed one)."""
    return _round_up(-(-n // n_dev), tile)


def _csr(a):
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    if a.shape[0] != a.shape[1]:
        raise ValueError("operator must be square")
    return a


def shard_halo(a, rows_loc: int) -> int:
    """The farthest any row's column reaches outside its own shard of
    rows_loc rows (JAX's `_shard_halo`)."""
    a = _as_2d_scipy(a).tocsr()
    nz = np.diff(a.indptr) > 0
    if not nz.any():
        return 0
    starts = a.indptr[:-1][nz]
    cols = a.indices.astype(np.int64)
    lo, hi = np.minimum.reduceat(cols, starts), np.maximum.reduceat(cols, starts)
    r0 = (np.flatnonzero(nz) // rows_loc) * rows_loc
    return int(max(np.maximum(r0 - lo, 0).max(),
                   np.maximum(hi - (r0 + rows_loc) + 1, 0).max()))


def halo_layout(a, n_dev: int, reorder: str = "auto", tile: int = ROW_TILE):
    """(csr, perm, halo, rows_loc): the matrix in the operator's row order
    (RCM-permuted when `reorder` asks for it: "rcm" always, "auto" when
    the natural order's halo exceeds a shard), the permutation (None
    without one) and the global halo, for shards of `shard_rows(n, n_dev,
    tile)` rows.  ValueError, "use gather_sharded_ell", when the halo
    needs n_dev or more hops."""
    if reorder not in ("none", "rcm", "auto"):
        raise ValueError(f"unknown reorder={reorder!r}")
    a = _csr(a)
    rows_loc = shard_rows(a.shape[0], n_dev, tile)
    perm = None
    halo = shard_halo(a, rows_loc)
    if reorder == "rcm" or (reorder == "auto" and halo > rows_loc):
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True), np.int64)
        a = a[perm][:, perm].tocsr()
        a.sum_duplicates()
        halo = shard_halo(a, rows_loc)
    halo_hops(halo, rows_loc, n_dev)
    return a, perm, halo, rows_loc


def halo_hops(halo: int, rows_loc: int, n_dev: int) -> int:
    """The neighbour distance the exchange must reach, ceil(halo /
    rows_loc); ValueError, "use gather_sharded_ell", at n_dev or more (as
    JAX's builder raises; a square matrix's halo stays within n_dev - 1
    hops, so this guards the arithmetic rather than a real matrix)."""
    hops = -(-halo // rows_loc) if halo else 0
    if hops >= n_dev:
        raise ValueError(
            f"halo={halo} needs {hops} neighbor hops on a {n_dev}-device "
            "mesh even after reordering — use gather_sharded_ell"
        )
    return hops


def _width(a) -> int:
    return max(int(np.diff(a.indptr).max(initial=0)), 1)


def _pack(a, rank, rows_loc, window_rows, halo, dtype, packer):
    """Rank `rank`'s rows of the ELL with column c stored as c - base +
    halo, base = (i // window_rows) window_rows, pad entries data 0 at
    `halo`.  The halo ELL takes window_rows = rows_loc; the gathered ELL
    window_rows = n_pad and halo = 0 (global columns, pads at 0)."""
    if packer not in ("native", "numpy"):
        raise ValueError(f"unknown packer={packer!r}")
    n, w, row0 = a.shape[0], _width(a), rank * rows_loc
    if packer == "native":
        from lanczos_tpu_torch import native

        return native.halo_ell_from_csr(a.indptr, a.indices, a.data, n, w,
                                        window_rows, halo, dtype, row0, rows_loc)
    data = np.zeros((rows_loc, w), dtype)
    idx = np.full((rows_loc, w), halo, np.int32)
    hi = min(n, row0 + rows_loc)
    if hi > row0:
        ptr = a.indptr[row0 : hi + 1].astype(np.int64)
        per_row = np.diff(ptr)
        rows = np.repeat(np.arange(row0, hi), per_row)
        slot = np.arange(ptr[0], ptr[-1]) - np.repeat(ptr[:-1], per_row)
        base = (rows // window_rows) * window_rows
        data[rows - row0, slot] = a.data[ptr[0] : ptr[-1]]
        idx[rows - row0, slot] = a.indices[ptr[0] : ptr[-1]] - base + halo
    return data, idx


def halo_shard(a, n_dev: int, rank: int, dtype=np.float32, reorder: str = "auto",
               packer: str = "native"):
    """Rank `rank`'s shard of the halo ELL on an n_dev-rank mesh, as NumPy:
    (data (rows_loc, w) in dtype, idx (rows_loc, w) int32 window
    positions, halo, rows_loc, perm or None).  Row for row JAX's
    `halo_sharded_ell` arrays [rank rows_loc, (rank + 1) rows_loc)."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    a, perm, halo, rows_loc = halo_layout(a, n_dev, reorder)
    data, idx = _pack(a, rank, rows_loc, rows_loc, halo, np_dtype(dtype), packer)
    return data, idx, halo, rows_loc, perm


def gather_shard(a, n_dev: int, rank: int, dtype=np.float32,
                 packer: str = "native"):
    """Rank `rank`'s shard of the gathered ELL, as NumPy: (data, idx
    global columns (pads 0), rows_loc); JAX's `gather_sharded_ell` rows."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    a = _csr(a)
    rows_loc = shard_rows(a.shape[0], n_dev)
    data, idx = _pack(a, rank, rows_loc, rows_loc * n_dev, 0, np_dtype(dtype),
                      packer)
    return data, idx, rows_loc


def local_spmm(data: torch.Tensor, idx: torch.Tensor, window: torch.Tensor):
    """The local ELL product: out[c, i] = sum_k data[i, k] window[c,
    idx[i, k]], window block-major (p, cols) -> (p, rows)."""
    p = window.shape[0]
    gathered = window.index_select(1, idx.reshape(-1)).view((p,) + tuple(data.shape))
    return (data * gathered).sum(dim=2)


class _RowSharded(LinearOperator):
    """This rank's view of a row-sharded operator: rank r holds rows
    [r rows_loc, (r + 1) rows_loc) of the operator's (permuted) row order
    at positions [offset, offset + rows_loc) of its state, a strip of
    `strip` entries; the ranks' strips joined in rank order are JAX's
    global state.  Subclasses set `strip` and `offset`."""

    shard_axis = -1  # the ranks' strips join into JAX's global (p, n) state
    offset = 0

    def __init__(self, mesh: Mesh, n_rows_true: int, rows_loc: int, perm=None):
        super().__init__()
        self.mesh = mesh
        self.n_rows_true, self.rows_loc = int(n_rows_true), int(rows_loc)
        self.perm = None if perm is None else np.asarray(perm, np.int64)

    @property
    def strip(self) -> int:
        return self.rows_loc

    @property
    def shape(self):
        return (self.n_rows_true, self.n_rows_true)

    @property
    def state_shape(self):
        return (self.strip,)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x[None])[0]

    def pad_vector(self, b) -> torch.Tensor:
        """Global natural-order b, (n,) or block-major (p, n) -> this
        rank's strip on its device, its rows permuted and placed at
        `offset`, zeros elsewhere; only those rows move."""
        b = torch.as_tensor(b).to(self.dtype)
        lo = self.mesh.rank * self.rows_loc
        hi = min(lo + self.rows_loc, self.n_rows_true)
        if self.perm is None:
            rows = b[..., lo:hi]
        else:
            sel = torch.from_numpy(self.perm[lo:hi]).to(b.device)
            rows = b.index_select(-1, sel)
        out = rows.new_zeros(tuple(rows.shape[:-1]) + (self.strip,))
        out[..., self.offset : self.offset + rows.shape[-1]] = rows
        return out.to(self.mesh.device)

    def unpad_shards(self, shards: torch.Tensor) -> torch.Tensor:
        """Every rank's strip stacked in rank order, (size, strip) or
        (size, p, strip) -> the natural-order (n,) or (p, n); no
        collective."""
        shards = shards[..., self.offset : self.offset + self.rows_loc]
        y = shards.movedim(0, -2).reshape(tuple(shards.shape[1:-1]) + (-1,))
        y = y[..., : self.n_rows_true]
        if self.perm is not None:
            inv = torch.from_numpy(np.argsort(self.perm)).to(y.device)
            y = y.index_select(-1, inv)
        return y

    def unpad_vector(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse of pad_vector, on every rank (an all-gather: a
        collective)."""
        return self.unpad_shards(self.mesh.all_gather(y))

    def local_index(self, i: int) -> int:
        """Flat position of natural-order index i in JAX's global state
        (the strips joined): the receiver index to pass as lc."""
        pos = int(i) if self.perm is None else int(np.flatnonzero(self.perm == int(i))[0])
        rank, row = divmod(pos, self.rows_loc)
        return rank * self.strip + self.offset + row

    def storage_trace_fn(self, i: int):
        """Receiver extractor at flat index i of JAX's global state: the
        value on rank i // strip, zero on every other rank (the Lanczos
        methods sum the trace over the ranks)."""
        owner, pos = divmod(int(i), self.strip)
        if owner == self.mesh.rank:
            return lambda q: q[..., pos].clone()
        return lambda q: q.new_zeros(q.shape[:-1])

    def trace_fn(self, lc: int):
        """The same for a natural-order index lc."""
        return self.storage_trace_fn(self.local_index(lc))


class _RowShardedEll(_RowSharded):
    """This rank's rows of a row-sharded ELL operator (rows_loc, w); its
    strip is its rows_loc rows."""

    def __init__(self, data: torch.Tensor, indices: torch.Tensor, mesh: Mesh,
                 n_rows_true: int, rows_loc: int, perm=None):
        super().__init__(mesh, n_rows_true, rows_loc, perm)
        self.register_buffer("data", data)
        self.register_buffer("indices", indices)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_padded(self) -> int:
        return self.rows_loc * self.mesh.size

    @property
    def nnz(self) -> int:
        """Stored slots over all ranks, JAX's n_padded x width."""
        return self.n_padded * self.data.shape[1]


class HaloShardedEll(_RowShardedEll):
    """Row-sharded banded ELL whose columns address this rank's window
    ``[halo | rows_loc local rows | halo]``; a product is the halo
    exchange, then the local gather."""

    def __init__(self, data, indices, mesh, n_rows_true, rows_loc, halo: int,
                 perm=None):
        super().__init__(data, indices, mesh, n_rows_true, rows_loc, perm)
        self.halo = int(halo)

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's rows of A X: (p, rows_loc) -> same (a collective
        when halo > 0)."""
        return local_spmm(self.data, self.indices,
                          self.mesh.halo_window(X, self.halo))


class GatherShardedEll(_RowShardedEll):
    """Row-sharded ELL with global columns; a product all-gathers x."""

    halo = 0

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's rows of A X: (p, rows_loc) -> same (a collective)."""
        full = self.mesh.all_gather(X)  # (size, p, rows_loc)
        full = full.permute(1, 0, 2).reshape(X.shape[0], -1)
        return local_spmm(self.data, self.indices, full)


def halo_sharded_ell(a, mesh: Mesh, dtype=torch.float32, reorder: str = "auto",
                     packer: str = "native") -> HaloShardedEll:
    """This rank's `HaloShardedEll` of the scipy matrix a, its buffers on
    `mesh.device` (see `halo_layout` for reorder and its ValueError)."""
    data, idx, halo, rows_loc, perm = halo_shard(a, mesh.size, mesh.rank, dtype,
                                                 reorder, packer)
    return HaloShardedEll(to_buffer(data, mesh.device), to_buffer(idx, mesh.device),
                          mesh, a.shape[0], rows_loc, halo, perm)


def gather_sharded_ell(a, mesh: Mesh, dtype=torch.float32,
                       packer: str = "native") -> GatherShardedEll:
    """This rank's `GatherShardedEll` of the scipy matrix a, on
    `mesh.device`."""
    data, idx, rows_loc = gather_shard(a, mesh.size, mesh.rank, dtype, packer)
    return GatherShardedEll(to_buffer(data, mesh.device), to_buffer(idx, mesh.device),
                            mesh, a.shape[0], rows_loc)
