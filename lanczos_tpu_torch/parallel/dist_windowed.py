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
the neighbours' rows into its halo slots (`Mesh.halo_strips`, JAX's k-hop
exchange), and runs K8 on it; K8's output rows outside ``[halo, halo +
rows_loc)`` are zero, so the output is the next state as it stands.  At
halo 0 (always on one rank) K8 runs on the state itself, as
`PaddedWindowedOperator` does.

Every shard's plan has the same row and column counts, so n128 is the
same on every rank and each rank computes it alone (asserted in
`windowed_shard`).  JAX must also force one window size (`force_wsz`) and
pad every shard's planes per chunk to the largest, and pad p to 8,
because one SPMD program has one static shape and Mosaic tiles sublanes
by 8; a rank's K8 launch here reads its own plan's ppc, needs no window
size and takes any p, so each rank keeps its own ppc and wsz, and p is
not padded.  `windowed_shard` is a pure host function of the scipy
matrix, the mesh size and a rank, so one process can build every rank's
shard (the tests, `chip_smoke.py`); a rank builds only its own.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_tpu_torch.ops.formats import np_dtype
from lanczos_tpu_torch.ops.window_ell import (
    LANES,
    PlanError,
    WindowedEllMatrix,
    _assemble,
    _pack_planes,
    padded_length,
)
from lanczos_tpu_torch.parallel.dist_operator import _RowSharded, halo_layout
from lanczos_tpu_torch.parallel.mesh import Mesh


def windowed_shard(a, n_dev: int, rank: int, dtype=np.float32,
                   reorder: str = "auto", cpb: int = 16, spg: int = 16,
                   ppc_cap: int = 48, wsz_cap: int = 1 << 20,
                   packer: str = "native"):
    """Rank `rank`'s windowed-ELL shard on an n_dev-rank mesh, as NumPy:
    (arrays, geometry, halo, rows_loc, perm or None), arrays and geometry
    as `WindowedEllMatrix` takes them.  The plan has halo + rows_loc rows
    (the first halo empty) and rows_loc + 2 halo columns (the window).
    Only this rank's rows of the CSR are sliced and packed.  The per-k
    planner only, as JAX's builder packs: PlanError where a chunk needs
    more than ppc_cap planes or a group's band exceeds wsz_cap, and
    `halo_layout`'s ValueError where the halo needs n_dev or more hops."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    a, perm, halo, rows_loc = halo_layout(a, n_dev, reorder, LANES)
    n = a.shape[0]
    lo = rank * rows_loc
    first = min(lo, n)
    n_loc = min(n, lo + rows_loc) - first
    n_rows, n_cols = halo + rows_loc, rows_loc + 2 * halo
    p0, p1 = int(a.indptr[first]), int(a.indptr[first + n_loc])
    indptr = np.zeros(n_rows + 1, np.int64)
    indptr[halo : halo + n_loc + 1] = a.indptr[first : first + n_loc + 1] - p0
    indptr[halo + n_loc + 1 :] = p1 - p0
    indices = a.indices[p0:p1].astype(np.int64) - (lo - halo)
    assert indices.size == 0 or (indices.min() >= 0 and indices.max() < n_cols)
    data = a.data[p0:p1].astype(np_dtype(dtype))
    planes = _pack_planes(indptr, indices, data, n_rows, ppc_cap, packer)
    arrays, geometry = _assemble(*planes, n_rows, n_cols, int(a.nnz), cpb, spg,
                                 wsz_cap)
    # every rank's plan has these row and column counts: one strip length
    assert geometry["n128"] == padded_length(n_rows, n_cols, cpb, spg)
    return arrays, geometry, halo, rows_loc, perm


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

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's strip of A X: (p, n128) -> a new (p, n128) (a
        collective when halo > 0)."""
        h, rl = self.halo, self.rows_loc
        if h == 0:
            return self.local.padded_mm(X.contiguous())
        work = X.clone(memory_format=torch.contiguous_format)
        work[:, :h], work[:, h + rl : rl + 2 * h] = self.mesh.halo_strips(
            X[:, h : h + rl], h)
        return self.local.padded_mm(work)


def halo_sharded_windowed(a, mesh: Mesh, dtype=torch.float32, reorder: str = "auto",
                          cpb: int = 16, spg: int = 16, ppc_cap: int = 48,
                          wsz_cap: int = 1 << 20,
                          packer: str = "native") -> HaloShardedWindowed:
    """This rank's `HaloShardedWindowed` of the scipy matrix a, its plan on
    `mesh.device` (see `windowed_shard`).  A shard that cannot be planned
    raises PlanError on every rank of a mesh with a process group (one
    `Mesh.any`), so that every rank takes the same fallback."""
    try:
        arrays, geometry, halo, rows_loc, perm = windowed_shard(
            a, mesh.size, mesh.rank, np_dtype(dtype), reorder, cpb, spg, ppc_cap,
            wsz_cap, packer)
        error = None
    except PlanError as e:
        error = e
    if mesh.group is not None and mesh.any(error is not None) and error is None:
        error = PlanError("another rank's shard exceeds the plan's caps")
    if error is not None:
        raise error
    local = WindowedEllMatrix(*arrays, None, **geometry, device=mesh.device)
    return HaloShardedWindowed(local, mesh, a.shape[0], rows_loc, halo, perm)
