"""The row-sharded windowed-ELL operator (`lanczos_tpu_torch/parallel/
dist_windowed.py`) in one process: every rank's shard built with a
`Mesh` that has no process group, against the JAX package's
`halo_sharded_windowed` on `make_mesh(k)` of conftest's 8 virtual devices
(its K8 in interpret mode), at k = 1, 2, 4, 8 on
tests/test_dist_windowed.py's fixtures (`torch_parallel_cases.
windowed_matrices`), with JAX's cpb=2, spg=2.  Each rank's product runs on
a work strip whose halo slots are filled by hand from the neighbours'
rows (what `Mesh.halo_strip` moves between ranks); the exchange itself,
Lanczos, eigsh, io and the checkpoint run on gloo ranks in
tests/test_torch_parallel.py's one spawn per world size.

Tolerances: halo, rows_loc, n128, perm, padded strips and receivers
exact; f32 products to 1e-5 of scale against JAX's; f64 to 1e-12 of scale
against scipy (JAX's K8 sums f64 in f32, `window_ell.py:669,679`, so f64
is held to scipy rather than JAX)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.parallel.dist_windowed import halo_sharded_windowed as jax_windowed
from lanczos_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lanczos_tpu_torch.ops.window_ell import PlanError
from lanczos_tpu_torch.parallel import dist_operator as D
from lanczos_tpu_torch.parallel import dist_windowed as W
from lanczos_tpu_torch.parallel.mesh import Mesh
from tests import torch_parallel_cases as cases

RANKS = (1, 2, 4, 8)
MATRICES = list(cases.windowed_matrices())
F32_RTOL, F64_RTOL = 1e-5, 1e-12


def _ops(k, name, dtype=torch.float32):
    a, reorder = cases.windowed_matrices()[name]
    return [W.halo_sharded_windowed(a, Mesh(rank, k, torch.device("cpu"), None),
                                    dtype=dtype, reorder=reorder, cpb=2, spg=2)
            for rank in range(k)]


@functools.cache
def _jax_op(k, name):
    a, reorder = cases.windowed_matrices()[name]
    return jax_windowed(a, jax_make_mesh(k), dtype=jnp.float32, reorder=reorder,
                        cpb=2, spg=2)


@functools.cache
def _jax_product(k, name):
    """JAX's global padded product of the start block, (p, k n128)."""
    jop = _jax_op(k, name)
    _, B = cases.windowed_start(jop.n_rows_true, torch.float32)
    return np.asarray(jop.mm(jop.pad_vector(B.numpy())))


def _by_hand(ops, strips):
    """Each rank's K8 product on its work strip, the halo slots filled from
    the neighbours' rows of the joined (permuted) global order."""
    h, rl = ops[0].halo, ops[0].rows_loc
    rows = torch.cat([s[:, h : h + rl] for s in strips], dim=-1)
    zeros = rows.new_zeros((rows.shape[0], h))
    ext = torch.cat([zeros, rows, zeros], dim=-1)
    outs = []
    for rank, (op, strip) in enumerate(zip(ops, strips)):
        work = strip.clone()
        work[:, : rl + 2 * h] = ext[:, rank * rl : rank * rl + rl + 2 * h]
        outs.append(op.local.padded_mm(work))
    return outs


def _assert_scaled(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_layout_matches_jax(k, name):
    """halo, rows_loc, the strip length n128, the permutation and nnz equal
    JAX's; every rank's plan has the shard's row and column counts."""
    jop = _jax_op(k, name)
    for op in _ops(k, name):
        assert (op.halo, op.rows_loc, op.n128) == (jop.halo, jop.rows_loc, jop.n128)
        assert op.nnz == jop.nnz and op.shape == jop.shape
        assert op.local.shape == (op.halo + op.rows_loc, op.rows_loc + 2 * op.halo)
        assert op.state_shape == (op.n128,) and op.shard_axis == -1
        if jop.is_permuted:
            np.testing.assert_array_equal(op.perm, np.asarray(jop.perm))
        else:
            assert op.perm is None
    assert (_ops(k, name)[0].perm is not None) == (name == "bipartite")


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_pad_vector_strips_are_jax_global_state(k, name):
    """The ranks' pad_vector strips, joined in rank order, are JAX's
    padded global state exactly, for a vector and a block; unpad_shards
    inverts them."""
    ops, jop = _ops(k, name), _jax_op(k, name)
    b, B = cases.windowed_start(jop.n_rows_true, torch.float32)
    for x in (b, B):
        strips = torch.stack([op.pad_vector(x) for op in ops])
        glued = torch.cat(list(strips), dim=-1)
        np.testing.assert_array_equal(glued.numpy(), np.asarray(jop.pad_vector(x.numpy())))
        torch.testing.assert_close(ops[0].unpad_shards(strips), x, rtol=0, atol=0)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_products_by_hand_match_jax(k, name):
    """Every rank's K8 product on its by-hand work strip, joined, against
    JAX's A.mm(A.pad_vector(X)) over the whole padded state (halo slots
    and pads included: zero on both sides), f32 to 1e-5 of scale."""
    ops = _ops(k, name)
    _, B = cases.windowed_start(ops[0].n_rows_true, torch.float32)
    outs = _by_hand(ops, [op.pad_vector(B) for op in ops])
    _assert_scaled(torch.cat(outs, dim=-1), _jax_product(k, name), F32_RTOL)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_f64_products_by_hand_match_scipy(k, name):
    """The same in f64, stitched, against scipy's product to 1e-12 of
    scale; rows outside each rank's own (halo slots, pads) exactly 0."""
    a = cases.windowed_matrices()[name][0]
    ops = _ops(k, name, torch.float64)
    _, B = cases.windowed_start(a.shape[0], torch.float64)
    outs = _by_hand(ops, [op.pad_vector(B) for op in ops])
    _assert_scaled(ops[0].unpad_shards(torch.stack(outs)), (a @ B.numpy().T).T, F64_RTOL)
    for rank, (op, y) in enumerate(zip(ops, outs)):
        rows = max(0, min(op.rows_loc, a.shape[0] - rank * op.rows_loc))
        y = y.clone()
        y[:, op.halo : op.halo + rows] = 0
        assert not y.any()


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_receivers_match_jax(k, name):
    """local_index(i) is JAX's (d n128 + h + r, through the permutation);
    storage_trace_fn(i) reads flat index i of the joined state on rank
    i // n128 only, zero on the others."""
    ops, jop = _ops(k, name), _jax_op(k, name)
    n = jop.n_rows_true
    _, B = cases.windowed_start(n, torch.float32)
    strips = [op.pad_vector(B) for op in ops]
    glued = torch.cat(strips, dim=-1)
    for i in sorted({0, min(511, n - 1), min(512, n - 1), n // 2, n - 1}):
        pos = ops[0].local_index(i)
        assert pos == jop.local_index(i)
        parts = [op.storage_trace_fn(pos)(s) for op, s in zip(ops, strips)]
        for rank, part in enumerate(parts):
            if rank != pos // ops[0].n128:
                assert not part.any()
        torch.testing.assert_close(sum(parts), glued[:, pos], rtol=0, atol=0)
        torch.testing.assert_close(sum(op.trace_fn(i)(s) for op, s in zip(ops, strips)),
                                   B[:, i], rtol=0, atol=0)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_from_arrays_on_jax_plans_matches_own_build(k, name):
    """HaloShardedWindowed.from_arrays on JAX's stacked plans (its shared
    ppc and window, Mosaic pads) gives every rank the same product as the
    port's own build, bit for bit."""
    jop = _jax_op(k, name)
    ops = _ops(k, name)
    arrays = [np.asarray(x) for x in (jop.planes_data, jop.planes_lidx, jop.planes_off,
                                      jop.wb, jop.perm)]
    geometry = dict(halo=jop.halo, rows_loc=jop.rows_loc, n_rows_true=jop.n_rows_true,
                    ppc=jop.ppc, cpb=jop.cpb, spg=jop.spg, wsz=jop.wsz, n128=jop.n128,
                    nnz_true=jop.nnz_true)
    carried = [W.HaloShardedWindowed.from_arrays(
        *arrays, mesh=Mesh(rank, k, torch.device("cpu"), None), **geometry)
        for rank in range(k)]
    _, B = cases.windowed_start(jop.n_rows_true, torch.float32)
    strips = [op.pad_vector(B) for op in ops]
    for got, want in zip(_by_hand(carried, strips), _by_hand(ops, strips)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for op, c in zip(ops, carried):
        assert c.local.ppc >= op.local.ppc and c.local.wsz == jop.wsz
        assert (c.perm is None) == (op.perm is None)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", RANKS)
def test_native_packer_equals_numpy_packer(k, name):
    a, reorder = cases.windowed_matrices()[name]
    for rank in range(k):
        (nat, g_nat, *rest_nat), (npy, g_npy, *rest_npy) = (
            W.windowed_shard(a, k, rank, np.float64, reorder, 2, 2, packer=packer)
            for packer in ("native", "numpy"))
        assert g_nat == g_npy and rest_nat[:2] == rest_npy[:2]
        for x, y in zip(nat, npy):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_a_row_wider_than_the_plane_cap_is_a_plan_error_as_in_jax():
    """A chunk needing more planes than ppc_cap raises PlanError where
    JAX's builder does (the per-k planner only, no greedy fallback: `auto`
    relies on it), on the shard that holds the wide rows."""
    from lanczos_tpu.ops.pallas.window_ell import PlanError as JaxPlanError

    a = cases.plan_error_matrix()
    for k in (1, 4):
        with pytest.raises(JaxPlanError):
            jax_windowed(a, jax_make_mesh(k), cpb=2, spg=2)
        with pytest.raises(PlanError, match="planes/chunk"):
            W.windowed_shard(a, k, 0, cpb=2, spg=2)
        with pytest.raises(PlanError):
            W.halo_sharded_windowed(a, Mesh(0, k, torch.device("cpu"), None))
    for rank in (1, 2, 3):  # the other shards plan
        W.windowed_shard(a, 4, rank, cpb=2, spg=2)


def test_too_many_hops_and_bad_options_are_value_errors(monkeypatch):
    """windowed_shard takes the halo layout's guard: a halo of n_dev or
    more shards raises "use gather_sharded_ell" (a square matrix cannot
    reach it, as in JAX, so the halo is forced); a bad reorder or rank
    raises too."""
    a = cases.windowed_matrices()["lap40"][0]
    with pytest.raises(ValueError, match="reorder"):
        W.windowed_shard(a, 2, 0, reorder="metis")
    with pytest.raises(ValueError, match="rank 2"):
        W.windowed_shard(a, 2, 2)
    monkeypatch.setattr(D, "shard_halo", lambda a, rows_loc: 2 * rows_loc)
    with pytest.raises(ValueError, match="use gather_sharded_ell"):
        W.windowed_shard(a, 2, 0, reorder="none")


def test_windowed_shards_use_128_row_shards_and_ell_keeps_8():
    """The row tile: the windowed shards are whole 128-lane chunks (JAX's
    LANES), the halo ELL's stay JAX's ROW_TILE of 8."""
    assert D.shard_rows(1000, 4) == 256 and D.shard_rows(1000, 4, W.LANES) == 256
    assert D.shard_rows(900, 4) == 232 and D.shard_rows(900, 4, W.LANES) == 256
    _, _, halo, rows, _ = W.windowed_shard(cases.windowed_matrices()["band300"][0], 4, 0,
                                           reorder="none", cpb=2, spg=2)
    assert (halo, rows) == (288, 256)


def test_a_plan_that_is_not_the_shards_is_refused():
    ops = _ops(2, "lap40")
    with pytest.raises(ValueError, match="local plan"):
        W.HaloShardedWindowed(ops[0].local, ops[0].mesh, ops[0].n_rows_true,
                              ops[0].rows_loc, ops[0].halo + 1)
