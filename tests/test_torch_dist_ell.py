"""The row-sharded ELL operators (`lanczos_tpu_torch/parallel/
dist_operator.py`) in one process: every rank's shard built by the pure
host builders against the JAX package's `halo_sharded_ell` /
`gather_sharded_ell` on `make_mesh(k)` of conftest's 8 virtual devices,
and the operators' host-side layout (pad_vector / unpad_shards, the
receivers).  The products, Lanczos, eigsh and expm on k gloo ranks are in
tests/test_torch_parallel.py, whose one spawn per world size runs them
(`tests/torch_parallel_cases.py` `ell_scenarios`).

Tolerances: shards, halo and perm exact (the same packing of the same
values); round trips exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.parallel import gather_sharded_ell as jax_gather
from lanczos_tpu.parallel import halo_sharded_ell as jax_halo
from lanczos_tpu.parallel import make_mesh as jax_make_mesh
from lanczos_tpu_torch.parallel import dist_operator as D
from lanczos_tpu_torch.parallel.mesh import Mesh
from tests import torch_parallel_cases as cases

RANKS = (1, 2, 4)
DTYPES = {"float32": np.float32, "float64": np.float64}
MATRICES = list(cases.ell_matrices())


def _local_op(a, k, rank, builder="halo", reorder="auto", dtype=torch.float64):
    mesh = Mesh(rank, k, torch.device("cpu"), None)
    if builder == "halo":
        return D.halo_sharded_ell(a, mesh, dtype=dtype, reorder=reorder)
    return D.gather_sharded_ell(a, mesh, dtype=dtype)


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_halo_shards_equal_jax(k, name, dname, packer):
    """data, indices, halo and perm of every rank equal JAX's global
    arrays' rows [r rows_loc, (r + 1) rows_loc), bit for bit."""
    a, reorder = cases.ell_matrices()[name]
    jop = jax_halo(a, jax_make_mesh(k), dtype=jnp.dtype(DTYPES[dname]), reorder=reorder)
    jdata, jidx = np.asarray(jop.data), np.asarray(jop.indices)
    for rank in range(k):
        data, idx, halo, rows, perm = D.halo_shard(a, k, rank, DTYPES[dname],
                                                   reorder, packer)
        assert (halo, rows * k) == (jop.halo, jop.n_padded)
        assert data.dtype == jdata.dtype and idx.dtype == np.int32
        np.testing.assert_array_equal(data, jdata[rank * rows : (rank + 1) * rows])
        np.testing.assert_array_equal(idx, jidx[rank * rows : (rank + 1) * rows])
        if jop.perm is None:
            assert perm is None
        else:
            np.testing.assert_array_equal(perm, np.asarray(jop.perm))


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_gather_shards_equal_jax(k, name, packer):
    a = cases.ell_matrices()[name][0]
    for dtype in DTYPES.values():
        jop = jax_gather(a, jax_make_mesh(k), dtype=jnp.dtype(dtype))
        for rank in range(k):
            data, idx, rows = D.gather_shard(a, k, rank, dtype, packer)
            assert rows * k == jop.n_padded
            np.testing.assert_array_equal(data, np.asarray(jop.data)[rank * rows :
                                                                   (rank + 1) * rows])
            np.testing.assert_array_equal(idx, np.asarray(jop.indices)[rank * rows :
                                                                     (rank + 1) * rows])


def test_auto_applies_rcm_where_jax_does():
    """The Maxwell operator's [E; H] order needs a halo wider than a shard
    at 4 ranks: "auto" reorders, with JAX's permutation, and the halo then
    fits in one hop; at 2 ranks it fits unpermuted.  "rcm" always
    reorders."""
    a = cases.ell_matrices()["maxwell"][0]
    for k, reordered in ((2, False), (4, True)):
        _, perm, halo, rows = D.halo_layout(a, k, "auto")
        assert (perm is not None) == reordered
        assert (D.shard_halo(a, rows) > rows) == reordered
        assert halo <= rows
    lap = cases.ell_matrices()["laplacian"][0]
    _, perm, halo, _ = D.halo_layout(lap, 2, "rcm")
    jop = jax_halo(lap, jax_make_mesh(2), dtype=jnp.float64, reorder="rcm")
    np.testing.assert_array_equal(perm, np.asarray(jop.perm))
    assert halo == jop.halo


def test_arrow_needs_several_hops_at_four_ranks():
    a = cases.ell_matrices()["arrow"][0]
    _, perm, halo, rows = D.halo_layout(a, 4, "none")
    assert perm is None and D.halo_hops(halo, rows, 4) == 3


def test_too_many_hops_and_bad_options_are_value_errors():
    with pytest.raises(ValueError, match="use gather_sharded_ell"):
        D.halo_hops(4 * 16, 16, 4)
    assert D.halo_hops(3 * 16, 16, 4) == 3 and D.halo_hops(0, 16, 1) == 0
    a = cases.ell_matrices()["laplacian"][0]
    with pytest.raises(ValueError, match="reorder"):
        D.halo_layout(a, 2, "metis")
    with pytest.raises(ValueError, match="packer"):
        D.halo_shard(a, 2, 0, packer="scipy")
    with pytest.raises(ValueError, match="rank 2"):
        D.halo_shard(a, 2, 2)
    with pytest.raises(ValueError, match="square"):
        D.gather_shard(a[:10], 2, 0)


def test_shard_halo_matches_jax():
    from lanczos_tpu.parallel.dist_operator import _shard_halo

    for a, _ in cases.ell_matrices().values():
        for rows in (8, 24, 64, 1000):
            assert D.shard_halo(a, rows) == _shard_halo(a, rows)


@pytest.mark.parametrize("builder", ["halo", "gather"])
@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_pad_vector_and_unpad_shards_round_trip(k, name, builder):
    """Every rank's pad_vector, stacked, is JAX's padded (permuted) global
    state; unpad_shards inverts it exactly; the pad rows are zero."""
    a, reorder = cases.ell_matrices()[name]
    b, B = cases.ell_start(a.shape[0], torch.float64)
    ops = [_local_op(a, k, r, builder, reorder) for r in range(k)]
    jop = (jax_halo(a, jax_make_mesh(k), dtype=jnp.float64, reorder=reorder)
           if builder == "halo" else jax_gather(a, jax_make_mesh(k), dtype=jnp.float64))
    for x in (b, B):
        shards = torch.stack([op.pad_vector(x) for op in ops])
        glued = torch.cat(list(shards), dim=-1)
        np.testing.assert_array_equal(glued.numpy(), np.asarray(jop.pad_vector(x.numpy())))
        assert not glued[..., a.shape[0]:].any()
        torch.testing.assert_close(ops[0].unpad_shards(shards), x, rtol=0, atol=0)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_storage_trace_fn_reads_its_owner_rank(k, name):
    """storage_trace_fn(i) reads flat index i of the padded global state on
    rank i // rows_loc only (zero elsewhere, for each block column);
    trace_fn(lc) reads the natural-order lc through local_index, which is
    JAX's."""
    a, reorder = cases.ell_matrices()[name]
    _, B = cases.ell_start(a.shape[0], torch.float64)
    ops = [_local_op(a, k, r, "halo", reorder) for r in range(k)]
    jop = jax_halo(a, jax_make_mesh(k), dtype=jnp.float64, reorder=reorder)
    shards = [op.pad_vector(B) for op in ops]
    glued = torch.cat(shards, dim=-1)
    n_pad = glued.shape[-1]
    for i in (0, ops[0].rows_loc - 1, n_pad // 2, a.shape[0] - 1, n_pad - 1):
        parts = [op.storage_trace_fn(i)(s) for op, s in zip(ops, shards)]
        owner = i // ops[0].rows_loc
        for rank, part in enumerate(parts):
            assert part.shape == (cases.ELL_P,)
            if rank != owner:
                assert not part.any()
        torch.testing.assert_close(sum(parts), glued[:, i], rtol=0, atol=0)
    for lc in (0, cases.ELL_LC, a.shape[0] - 1):
        assert ops[0].local_index(lc) == jop.local_index(lc)
        got = sum(op.trace_fn(lc)(s) for op, s in zip(ops, shards))
        torch.testing.assert_close(got, B[:, lc], rtol=0, atol=0)


def test_operator_attributes_match_jax():
    a, reorder = cases.ell_matrices()["maxwell"]
    for k in RANKS:
        jop = jax_halo(a, jax_make_mesh(k), dtype=jnp.float32, reorder=reorder)
        op = _local_op(a, k, k - 1, "halo", reorder, torch.float32)
        assert op.shape == jop.shape and op.dtype == torch.float32
        assert (op.nnz, op.n_padded, op.halo) == (jop.nnz, jop.n_padded, jop.halo)
        assert op.state_shape == (op.rows_loc,) and op.shard_axis == -1
        gop = _local_op(a, k, 0, "gather")
        assert (gop.halo, gop.perm, gop.n_padded) == (0, None, jop.n_padded)


def test_local_spmm_is_the_ell_gather():
    """The local product over a window, against a dense loop."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((5, 3)))
    idx = torch.from_numpy(rng.integers(0, 9, (5, 3)).astype(np.int32))
    window = torch.from_numpy(rng.standard_normal((2, 9)))
    want = np.zeros((2, 5))
    for c in range(2):
        for i in range(5):
            want[c, i] = sum(data[i, s].item() * window[c, idx[i, s]].item()
                             for s in range(3))
    np.testing.assert_allclose(D.local_spmm(data, idx, window).numpy(), want,
                               rtol=1e-14)
