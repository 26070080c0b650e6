"""The row-sharded windowed-ELL operator built as a deployment builds it,
each rank from its own rows alone (`parallel/dist_windowed.py`
`windowed_shard_rows`, `halo_sharded_windowed_rows`), and the mesh's
counters (`parallel/mesh.py`).

The matrix is the banded deployments' synthetic SPD band (offsets 0, +-1,
+-7, +-64, +-513, +-4999, five spikes on the diagonal); a rank's rows are
made from its diagonals directly, never sliced out of the whole matrix.
Their plan is held bit-equal to `windowed_shard`'s of the whole matrix
(which tests/test_torch_dist_windowed.py holds to the JAX package), at 2
and 4 ranks, with an uneven last shard and a halo of one and of two hops.
On two gloo ranks the eigsh on the rows-built operator agrees with the
one-device eigsh to float32 rounding, and one product moves the mesh's
counters by one exchange of the halo rows; on one rank it moves none."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
from lanczos_tpu_torch.ops.window_ell import PaddedWindowedOperator, windowed_from_scipy
from lanczos_tpu_torch.parallel import dist_windowed as W
from lanczos_tpu_torch.parallel import launch
from lanczos_tpu_torch.parallel.mesh import Mesh
from lanczos_tpu_torch.utils import tracing

OFFSETS = (1, 7, 64, 513, 4999)
SPIKES = (500.0, 450.0, 400.0, 350.0, 300.0)
SEED = 11
# (rows, ranks): one hop, two hops (rows_loc 3072 < 4999) with an uneven
# last shard, and one hop with an uneven last shard
SHAPES = [(12000, 2), (12000, 4), (65236, 4)]
P, M, K = 4, 10, 4
EIGSH_ROWS = 12000
CPB = SPG = 2  # a small strip (12,288 rows, not 32,768) keeps the CPU eigsh quick


def offsets(n: int):
    return [o for o in OFFSETS if o < n]


def diagonals(n: int):
    """(upper {o: (n - o,)}, diag (n,)) in float32, from the seed."""
    rng = np.random.default_rng(SEED)
    rowsum = np.zeros(n)
    upper = {}
    for o in offsets(n):
        u = (0.25 * (rng.standard_normal(n - o) + rng.standard_normal(n - o))).astype(np.float32)
        rowsum[: n - o] += np.abs(u)
        rowsum[o:] += np.abs(u)
        upper[o] = u
    rowsum[rng.permutation(n)[: len(SPIKES)]] += SPIKES
    return upper, (rowsum + 1.0).astype(np.float32)


def band_rows(n: int, lo: int, hi: int):
    """Rows [lo, hi) of the band as a CSR with global columns, made from
    the diagonals row by row (columns ascending)."""
    upper, diag = diagonals(n)
    offs = sorted([-o for o in offsets(n)] + [0] + offsets(n))
    i = np.arange(lo, hi)
    cols, vals = [], []
    for o in offs:
        c = i + o
        v = np.where((c >= 0) & (c < n), 1.0, 0.0).astype(np.float32)
        if o == 0:
            v = diag[i]
        elif o > 0:
            v = np.where(c < n, upper[o][np.minimum(i, n - o - 1)], 0.0)
        else:
            v = np.where(c >= 0, upper[-o][np.maximum(c, 0)], 0.0)
        cols.append(c)
        vals.append(v.astype(np.float32))
    cols, vals = np.stack(cols, 1), np.stack(vals, 1)
    keep = (cols >= 0) & (cols < n)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))])
    return sp.csr_matrix((vals[keep], cols[keep].astype(np.int32), indptr),
                         shape=(hi - lo, n))


def whole(n: int):
    return band_rows(n, 0, n)


@pytest.mark.parametrize("n,n_dev", SHAPES)
def test_rows_plan_is_the_whole_matrix_plan(n, n_dev):
    a = whole(n)
    rows_loc = W.shard_rows(n, n_dev, 128)
    reaches = []
    for rank in range(n_dev):
        arrays, geometry, halo, rl, perm = W.windowed_shard(a, n_dev, rank, reorder="none")
        assert rl == rows_loc and perm is None
        lo, hi = W.shard_bounds(n, n_dev, rank)
        rows = band_rows(n, lo, hi)
        reaches.append(W.rows_reach(rows, lo, rows_loc))
        got, got_geometry = W.windowed_shard_rows(rows, n, n_dev, rank, halo, a.nnz)
        assert got_geometry == geometry
        for g, w in zip(got, arrays):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert max(reaches) == halo == max(OFFSETS)
    assert n - (n_dev - 1) * rows_loc < rows_loc  # an uneven last shard
    assert -(-halo // rows_loc) == (2 if rows_loc < halo else 1)


def test_rows_plan_keeps_the_natural_order_only():
    n = 2048
    mesh = Mesh(0, 1, torch.device("cpu"), None)
    for reorder in ("rcm", "auto"):
        with pytest.raises(ValueError, match="natural order"):
            W.halo_sharded_windowed_rows(band_rows(n, 0, n), n, mesh, reorder=reorder)
    with pytest.raises(ValueError, match="rows are"):
        W.windowed_shard_rows(band_rows(n, 0, n - 1), n, 1, 0, 0, 0)


def _start(n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(SEED)
    return torch.randn((P, n), generator=g, dtype=torch.float32)


def _eigsh(op, b):
    vals, _, _ = block_lanczos_eigsh(op, b, M, K, reorth="full", normalize="qr",
                                     breakdown_eps=1e-4, eig_backend="newton")
    return vals


def _moved(before: dict) -> dict:
    after = tracing.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("mesh.") and v != before.get(k, 0)}


def rank_eigsh(mesh, n):
    """On a rank: its operator from its own rows, the counters one
    product moves, and the eigsh's Ritz values."""
    lo, hi = W.shard_bounds(n, mesh.size, mesh.rank)
    op = W.halo_sharded_windowed_rows(band_rows(n, lo, hi), n, mesh, cpb=CPB, spg=SPG)
    u = op.pad_vector(_start(n))
    before = tracing.counters()
    op.mm(u)
    return {"moved": _moved(before), "halo": op.halo, "vals": _eigsh(op, u)}


@pytest.fixture(scope="module")
def two_ranks():
    return launch.run(rank_eigsh, 2, EIGSH_ROWS, device="cpu", timeout=120.0)


def test_two_ranks_eigsh_matches_one_device(two_ranks):
    n = EIGSH_ROWS
    one = PaddedWindowedOperator(windowed_from_scipy(whole(n), reorder="none", cpb=CPB,
                                                     spg=SPG, device="cpu"))
    want = _eigsh(one, one.base.pack(_start(n)))
    for r in two_ranks:
        torch.testing.assert_close(r["vals"], want, rtol=2e-6, atol=0)
    torch.testing.assert_close(two_ranks[0]["vals"], two_ranks[1]["vals"], rtol=0, atol=0)


def test_one_product_moves_the_mesh_counters_by_one_exchange(two_ranks):
    for r in two_ranks:
        assert r["halo"] == max(OFFSETS)
        # each of two ranks sends its P x halo boundary rows to its one neighbour
        assert r["moved"] == {"mesh.halo": 1, "mesh.halo_bytes": P * r["halo"] * 4}


def test_one_rank_moves_no_mesh_counter():
    n = 4096
    op = W.halo_sharded_windowed_rows(band_rows(n, 0, n), n,
                                      Mesh(0, 1, torch.device("cpu"), None))
    assert op.halo == 0
    u = op.pad_vector(_start(n))
    before = tracing.counters()
    op.mm(u)
    assert _moved(before) == {}
