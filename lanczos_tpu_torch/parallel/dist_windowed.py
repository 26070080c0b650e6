"""Row-sharded windowed-ELL operator (port of
`lanczos_tpu/parallel/dist_windowed.py`): the multi-device path for
assembled matrices, K8 on every rank's shard.

The rows are split as for `HaloShardedEll`, but in shards of rows_loc =
round_up(ceil(n / n_dev), 128) rows (JAX's LANES), and each rank holds
its shard as a windowed-ELL plan (`ops/window_ell.py`) over ``halo +
rows_loc`` rows: the first `halo` rows empty, then its rows, with columns
in its halo-extended window ``[halo | rows_loc | halo]``.  A rank's state
is the plan's padded strip of n128 entries, ``[halo zeros | rows_loc
rows | halo zeros | pad]``; the ranks' strips joined in rank order are
JAX's global (p, n_dev n128) state, so checkpoints, receivers
(`local_index`, `storage_trace_fn`) and `pad_vector` match JAX's index
for index.

The halo slots of a persisted state stay zero, so Grams over the strips
are exact.  A product copies the state once into a work strip, writes
the neighbours' rows into its halo slots (`Mesh.halo_strip`, JAX's k-hop
exchange), and runs K8 on it; K8's output rows outside ``[halo, halo +
rows_loc)`` are zero, so the output is the next state as it stands.  At
halo 0 (always on one rank) K8 runs on the state itself, as
`PaddedWindowedOperator` does.

Every shard's plan has the same row and column counts, so n128 is the
same on every rank and each rank computes it alone (asserted in
`windowed_shard_rows`).  JAX must also force one window size (`force_wsz`) and
pad every shard's planes per chunk to the largest, and pad p to 8,
because one SPMD program has one static shape and Mosaic tiles sublanes
by 8; a rank's K8 launch here reads its own plan's ppc, needs no window
size and takes any p, so each rank keeps its own ppc and wsz, and p is
not padded.  `windowed_shard` is a pure host function of the scipy
matrix, the mesh size and a rank, so one process can build every rank's
shard (the tests, `chip_smoke.py`); a rank builds only its own.  It
slices the rank's rows out of the whole matrix and packs them with
`windowed_shard_rows`, the one packing path, which a deployment calls
through `halo_sharded_windowed_rows` with only its own rows: there the
ranks agree on the halo and the nonzero count in one all-gather, and no
rank ever holds the whole matrix (natural order only).
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_tpu_torch.ops.formats import _as_2d_scipy, np_dtype
from lanczos_tpu_torch.ops.window_ell import (
    LANES,
    PlanError,
    WindowedEllMatrix,
    _assemble,
    _pack_planes,
    padded_length,
)
from lanczos_tpu_torch.parallel.dist_operator import (
    _RowSharded,
    halo_hops,
    halo_layout,
    shard_rows,
)
from lanczos_tpu_torch.parallel.mesh import Mesh
from lanczos_tpu_torch.utils import tracing


def windowed_shard(a, n_dev: int, rank: int, dtype=np.float32,
                   reorder: str = "auto", cpb: int = 16, spg: int = 16,
                   ppc_cap: int = 48, wsz_cap: int = 1 << 20,
                   packer: str = "native"):
    """Rank `rank`'s windowed-ELL shard on an n_dev-rank mesh, as NumPy:
    (arrays, geometry, halo, rows_loc, perm or None), arrays and geometry
    as `WindowedEllMatrix` takes them.  The whole matrix sets the order
    (`halo_layout`: RCM where `reorder` asks for it) and the halo; then
    this rank's rows are sliced out and packed by `windowed_shard_rows`.
    `halo_layout`'s ValueError where the halo needs n_dev or more hops."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    a, perm, halo, rows_loc = halo_layout(a, n_dev, reorder, LANES)
    lo, hi = shard_bounds(a.shape[0], n_dev, rank)
    arrays, geometry = windowed_shard_rows(
        a[lo:hi], a.shape[0], n_dev, rank, halo, int(a.nnz), dtype, cpb, spg,
        ppc_cap, wsz_cap, packer)
    return arrays, geometry, halo, rows_loc, perm


def shard_bounds(n: int, n_dev: int, rank: int) -> tuple[int, int]:
    """[lo, hi): the rows of the n-row matrix that rank `rank` of n_dev
    holds, lo = rank rows_loc (hi - lo < rows_loc on a short last shard,
    0 past the end)."""
    rows_loc = shard_rows(n, n_dev, LANES)
    lo = min(rank * rows_loc, n)
    return lo, min(lo + rows_loc, n)


def rows_reach(rows, lo: int, rows_loc: int) -> int:
    """The farthest a column of the rows [lo, lo + rows_loc) (a scipy CSR
    with global columns) reaches outside them: `shard_halo`'s rule for
    one shard, whose maximum over the shards is the matrix's halo."""
    if rows.nnz == 0:
        return 0
    return max(lo - int(rows.indices.min()),
               int(rows.indices.max()) - (lo + rows_loc - 1), 0)


def windowed_shard_rows(rows, n: int, n_dev: int, rank: int, halo: int, nnz: int,
                        dtype=np.float32, cpb: int = 16, spg: int = 16,
                        ppc_cap: int = 48, wsz_cap: int = 1 << 20,
                        packer: str = "native"):
    """Rank `rank`'s windowed-ELL shard from its own rows alone, as NumPy:
    (arrays, geometry) as `WindowedEllMatrix` takes them.  `rows`: the
    rows `shard_bounds(n, n_dev, rank)` of an n x n matrix in its natural
    order, as a scipy CSR with global columns; `halo`: the matrix's halo
    (the largest `rows_reach` of any shard); `nnz`: its nonzeros.  The
    plan has halo + rows_loc rows (the first halo empty) and rows_loc + 2
    halo columns (the window).  The per-k planner only, as JAX's
    `halo_sharded_windowed` packs: PlanError where a chunk needs more than
    ppc_cap planes or a group's band exceeds wsz_cap; `halo_hops`'s
    ValueError where the halo needs n_dev or more hops."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    rows_loc = shard_rows(n, n_dev, LANES)
    lo, hi = shard_bounds(n, n_dev, rank)
    rows = _as_2d_scipy(rows).tocsr()
    if rows.shape != (hi - lo, n):
        raise ValueError(f"rank {rank}'s rows are {(hi - lo, n)}, not {rows.shape}")
    halo_hops(halo, rows_loc, n_dev)
    n_loc = hi - lo
    n_rows, n_cols = halo + rows_loc, rows_loc + 2 * halo
    indptr = np.zeros(n_rows + 1, np.int64)
    indptr[halo : halo + n_loc + 1] = rows.indptr
    indptr[halo + n_loc + 1 :] = rows.indptr[-1]
    indices = rows.indices.astype(np.int64) - (lo - halo)
    assert indices.size == 0 or (indices.min() >= 0 and indices.max() < n_cols)
    data = rows.data.astype(np_dtype(dtype))
    planes = _pack_planes(indptr, indices, data, n_rows, ppc_cap, packer)
    arrays, geometry = _assemble(*planes, n_rows, n_cols, int(nnz), cpb, spg,
                                 wsz_cap)
    # every rank's plan has these row and column counts: one strip length
    assert geometry["n128"] == padded_length(n_rows, n_cols, cpb, spg)
    return arrays, geometry


class HaloShardedWindowed(_RowSharded):
    """This rank's shard of a row-sharded windowed-ELL operator: `local`,
    its `WindowedEllMatrix` over halo + rows_loc rows and the window's
    columns; a state is the (p, n128) strip ``[halo zeros | rows | halo
    zeros | pad]``.  A product is the halo exchange into a work copy,
    then K8."""

    def __init__(self, local: WindowedEllMatrix, mesh: Mesh, n_rows_true: int,
                 rows_loc: int, halo: int, perm=None):
        super().__init__(mesh, n_rows_true, rows_loc, perm)
        if local.shape != (halo + rows_loc, rows_loc + 2 * halo):
            raise ValueError(
                f"the local plan is {local.shape}, not the shard's "
                f"{(halo + rows_loc, rows_loc + 2 * halo)}")
        self.local = local
        self.halo = int(halo)

    @classmethod
    def from_arrays(cls, planes_data, planes_lidx, planes_off, wb, perm, *,
                    mesh: Mesh, halo, rows_loc, n_rows_true, ppc, cpb, spg,
                    wsz, n128, nnz_true):
        """This rank's operator from a JAX `HaloShardedWindowed`'s arrays
        (NumPy: the n_dev shards' plans stacked on the leading axis, perm
        (n,) or (0,)) and static fields: slices out rank `mesh.rank`'s
        plan and reads it with `WindowedEllMatrix.from_arrays`."""
        arrays = [np.asarray(x) for x in (planes_data, planes_lidx, planes_off, wb)]
        if any(x.shape[0] % mesh.size for x in arrays):
            raise ValueError(f"the plans do not split into {mesh.size} shards")
        mine = [x.reshape((mesh.size, -1) + x.shape[1:])[mesh.rank] for x in arrays]
        local = WindowedEllMatrix.from_arrays(
            *mine, np.zeros((0,), np.int64), n_rows_true=halo + rows_loc,
            n_cols_true=rows_loc + 2 * halo, ppc=ppc, cpb=cpb, spg=spg, wsz=wsz,
            n128=n128, nnz_true=nnz_true, device=mesh.device)
        perm = np.asarray(perm)
        return cls(local, mesh, n_rows_true, rows_loc, halo,
                   perm if perm.size else None)

    @property
    def strip(self) -> int:
        return self.local.n128

    @property
    def offset(self) -> int:
        return self.halo

    @property
    def n128(self) -> int:
        return self.local.n128

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def nnz(self) -> int:
        """The matrix's nonzeros (JAX's nnz_true)."""
        return self.local.nnz_true

    @tracing.spanned("lt.op.apply")
    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's strip of A X: (p, n128) -> a new (p, n128) (a
        collective when halo > 0)."""
        if self.halo == 0:
            return self.local.padded_mm(X.contiguous())
        return self.local.padded_mm(
            self.mesh.halo_strip(X, self.halo, self.rows_loc, self.halo))


def halo_sharded_windowed(a, mesh: Mesh, dtype=torch.float32, reorder: str = "auto",
                          cpb: int = 16, spg: int = 16, ppc_cap: int = 48,
                          wsz_cap: int = 1 << 20,
                          packer: str = "native") -> HaloShardedWindowed:
    """This rank's `HaloShardedWindowed` of the scipy matrix a, its plan on
    `mesh.device` (see `windowed_shard`).  A shard that cannot be planned
    raises PlanError on every rank of a mesh with a process group (one
    `Mesh.any`), so that every rank takes the same fallback."""
    def plan():
        arrays, geometry, halo, rows_loc, perm = windowed_shard(
            a, mesh.size, mesh.rank, np_dtype(dtype), reorder, cpb, spg, ppc_cap,
            wsz_cap, packer)
        return arrays, geometry, halo, perm

    return _planned(plan, mesh, mesh.group is not None, a.shape[0])


def halo_sharded_windowed_rows(rows, n: int, mesh: Mesh, dtype=torch.float32,
                               reorder: str = "none", cpb: int = 16,
                               spg: int = 16) -> HaloShardedWindowed:
    """This rank's `HaloShardedWindowed` of an n x n matrix from this
    rank's rows alone (`shard_bounds(n, mesh.size, mesh.rank)`, a scipy
    CSR with global columns), as a deployment builds it: no rank holds
    the whole matrix.  Each rank's `rows_reach` and nonzeros meet in one
    all-gather, which gives every rank the matrix's halo and nnz; the plan
    is then `windowed_shard_rows`', bit for bit the one `windowed_shard`
    packs from the whole matrix with reorder "none".  Only "none": a
    reordering (RCM) needs the whole graph.  A PlanError on any rank is
    every rank's, as in `halo_sharded_windowed`."""
    if reorder != "none":
        raise ValueError(
            f"reorder={reorder!r}: a rank that builds from its own rows keeps the "
            "natural order (RCM needs the whole graph); use halo_sharded_windowed")
    rows = _as_2d_scipy(rows).tocsr()
    lo, _ = shard_bounds(n, mesh.size, mesh.rank)
    rows_loc = shard_rows(n, mesh.size, LANES)
    halo, nnz = rows_reach(rows, lo, rows_loc), rows.nnz
    if mesh.size > 1:
        mine = torch.tensor([halo, nnz], dtype=torch.int64, device=mesh.device)
        every = mesh.all_gather(mine).cpu()
        halo, nnz = int(every[:, 0].max()), int(every[:, 1].sum())

    def plan():
        arrays, geometry = windowed_shard_rows(
            rows, n, mesh.size, mesh.rank, halo, nnz, np_dtype(dtype), cpb, spg)
        return arrays, geometry, halo, None

    return _planned(plan, mesh, mesh.size > 1, n)


def _planned(plan, mesh: Mesh, agree: bool, n: int) -> HaloShardedWindowed:
    """The operator of `plan()` ((arrays, geometry, halo, perm)) on this
    rank; with `agree`, a PlanError on any rank is raised on every rank
    (one `Mesh.any`)."""
    try:
        arrays, geometry, halo, perm = plan()
        error = None
    except PlanError as e:
        error = e
    if agree and mesh.any(error is not None) and error is None:
        error = PlanError("another rank's shard exceeds the plan's caps")
    if error is not None:
        raise error
    local = WindowedEllMatrix(*arrays, None, **geometry, device=mesh.device)
    rows_loc = geometry["n_rows_true"] - halo
    return HaloShardedWindowed(local, mesh, n, rows_loc, halo, perm)
