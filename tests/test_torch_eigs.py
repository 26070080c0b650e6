"""The port's eigsh drivers (methods/eigs.py) and TSQR (ops/tsqr.py)
against the JAX package's, in f64 on the CPU.

Tolerances: tsqr 1e-12 of scale (one Householder QR per chunk and one of
the stacked R factors, in LAPACK on both sides); Ritz values and vectors
1e-10 of scale, residual bounds 1e-8 of scale (the same recurrence and
one eigh of T, rounded in other orders); measured relative residuals,
which sit at rounding level for converged pairs, 1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods import eigs as jeigs
from lanczos_tpu.ops.operator import MatrixOperator as JaxMatrix
from lanczos_tpu.ops.tsqr import tsqr as jax_tsqr
from lanczos_tpu_torch.methods import eigs
from lanczos_tpu_torch.ops.kernels.tsqr import (TsqrPlan, householder_tsqr, tile_tree_plain,
                                               tsqr_plan)
from lanczos_tpu_torch.ops.operator import MatrixOperator
from lanczos_tpu_torch.ops.tsqr import tsqr, tsqr_rows
from lanczos_tpu_torch.probes import library_tsqr, qr_errors
from lanczos_tpu_torch.utils import tracing

RTOL = 1e-10


def _close(got, want, rtol=RTOL, name=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


def _spd(n, rng, top=(50.0, 40.0, 30.0, 20.0, 10.0)):
    """Random SPD matrix with a separated top of the spectrum."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([top, rng.random(n - len(top))])
    return (q * d) @ q.T, np.sort(d)


@pytest.mark.parametrize("n,p,c", [(64, 4, 8), (1000, 6, 8), (37, 3, 4)])
def test_tsqr_matches_jax(n, p, c, rng):
    """tests/test_tsqr.py's shapes: the same factors (signs fixed so that
    diag(R) >= 0) and a = q r."""
    a = rng.standard_normal((n, p))
    qj, rj = jax_tsqr(jnp.asarray(a), n_chunks=c)
    q, r = tsqr(torch.from_numpy(a), n_chunks=c)
    _close(q, qj, 1e-12, "q")
    _close(r, rj, 1e-12, "r")
    assert torch.all(torch.diagonal(r) >= 0)
    np.testing.assert_allclose((q @ r).numpy(), a, rtol=0, atol=1e-12)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(p), rtol=0, atol=1e-12)


def _numpy_qr(a):
    """NumPy's QR with its signs fixed so that diag(R) >= 0."""
    qn, rn = np.linalg.qr(a)
    d = np.where(np.diag(rn) < 0, -1.0, 1.0)
    return qn * d, rn * d[:, None]


@pytest.mark.parametrize("n,p,c", [(64, 4, 8), (1000, 6, 8), (37, 3, 4)])
def test_tile_tree_matches_jax_and_numpy(n, p, c, rng):
    """T1's plain tile tree on the block-major state, at
    tests/test_tsqr.py's shapes: the JAX tsqr's factors and NumPy's."""
    a = rng.standard_normal((n, p))
    x = torch.from_numpy(a.T.copy())
    q, r = tile_tree_plain(x, tsqr_plan(n, p, 8, c))
    qj, rj = jax_tsqr(jnp.asarray(a), n_chunks=c)
    qn, rn = _numpy_qr(a)
    for want_q, want_r in ((np.asarray(qj), np.asarray(rj)), (qn, rn)):
        _close(q.T, want_q, 1e-12, "q")
        _close(r, want_r, 1e-12, "r")


@pytest.mark.parametrize("p", [1, 3, 8, 16])
@pytest.mark.parametrize("n", [1031, 2049, 4100])
def test_tile_tree_ragged_n_and_widths(n, p, rng):
    """n not a multiple of the tile (2049 at p = 3 leaves a last tile of
    one row, fewer than p), at each kernel width and p = 1: NumPy's
    factors, q block-major and contiguous, R alone the same R."""
    a = rng.standard_normal((n, p))
    x = torch.from_numpy(a.T.copy())
    plan = tsqr_plan(n, p, 8)
    assert n % plan.tile
    q, r = tile_tree_plain(x, plan)
    qn, rn = _numpy_qr(a)
    _close(q.T, qn, 1e-12, "q")
    _close(r, rn, 1e-12, "r")
    assert q.shape == (p, n) and q.is_contiguous()
    assert torch.equal(tile_tree_plain(x, plan, want_q=False)[1], r)
    assert torch.equal(r, torch.triu(r)) and bool((torch.diagonal(r) >= 0).all())


@pytest.mark.parametrize("chunks", [None, 2, 5, 16])
def test_tile_tree_chunking_invariant(chunks, rng):
    """Tiles of 128, 52 and 16 rows (one to four levels below the root)
    and the kernel's 512: the same factors."""
    a = torch.from_numpy(rng.standard_normal((5, 256)))
    q, r = householder_tsqr(a, plan=tsqr_plan(256, 5, 8, chunks))
    q1, r1 = householder_tsqr(a, plan=tsqr_plan(256, 5, 8, 1))
    _close(q, q1.numpy(), 1e-12, "q")
    _close(r, r1.numpy(), 1e-12, "r")


def test_tile_tree_ill_conditioned_f32_stays_orthonormal(rng):
    """Singular values 1 down to 1e-4 in float32 (the eigsh cell's
    breakdown_eps lets such an R through): ||Q^T Q - I|| stays at the eps
    level of the torch.linalg.qr tree the port ran before T1, where a
    Gram-based QR (CholeskyQR, condition squared: 1e8, past float32's 1 /
    eps) loses orthogonality by orders of magnitude."""
    n, p = 50_000, 8
    u, _ = np.linalg.qr(rng.standard_normal((n, p)))
    v, _ = np.linalg.qr(rng.standard_normal((p, p)))
    x = torch.from_numpy(((u * np.geomspace(1.0, 1e-4, p)) @ v.T).T.astype(np.float32).copy())
    eps = float(torch.finfo(torch.float32).eps)
    got, lib = qr_errors(x, *tsqr_rows(x)), qr_errors(x, *library_tsqr(x))
    for g, w in zip(got, lib):
        assert g <= max(2 * w, 4 * eps)
    r = torch.linalg.cholesky(x @ x.T).T  # CholeskyQR: R from the Gram
    q = torch.linalg.solve_triangular(r.T, x, upper=False)
    assert qr_errors(x, q, r)[1] > 1e3 * got[1]


SCALES = [(np.float32, 1e-25), (np.float32, 1e20), (np.float64, 1e-170), (np.float64, 1e170)]
# columns from under- to overflow side by side: a product of two columns
# (1e10 x 1e28) overflows where neither's squares do
MIXED = {np.float32: [1e10, 1e28, 1e-25, 1.0, 1e20, 1e-20],
         np.float64: [1e150, 1e300, 1e-300, 1.0, 1e170, 1e-170]}


def _scaled_block(rng, n, p, dtype, scale, layout):
    """(a, x, cols): an (n, p) Gaussian block with every column ("whole"),
    every other column ("alternate") scaled by `scale`, or its columns by
    MIXED ("mixed"), in `dtype`; x its block-major transpose and cols the
    columns' scales."""
    cols = {"whole": np.full(p, scale), "alternate": np.where(np.arange(p) % 2, scale, 1.0),
            "mixed": np.array(MIXED[dtype])}[layout]
    a = (rng.standard_normal((n, p)) * cols).astype(dtype)
    return a.astype(np.float64), torch.from_numpy(a.T.copy()), cols


@pytest.mark.parametrize("layout", ["whole", "alternate", "mixed"])
@pytest.mark.parametrize("dtype,scale", SCALES)
def test_tile_tree_scales_tiny_and_huge_columns(dtype, scale, layout, rng):
    """Columns whose squares underflow (1e-25 in float32: 1e-50, under the
    smallest subnormal) or overflow (1e20: 1e40, past float32's largest),
    and the float64 analogues, the whole block, every other column or
    columns of each kind side by side: each column of x.T - q.T r at
    rounding level of that column, q orthonormal, and NumPy's factors
    column by column.  Unscaled, the tiny columns' reflections vanish and
    the huge ones' turn to inf and NaN."""
    n, p = 3000, 6
    a, x, cols = _scaled_block(rng, n, p, dtype, scale, layout)
    q, r = tile_tree_plain(x, tsqr_plan(n, p, x.element_size(), 6))
    q, r = q.double().numpy(), r.double().numpy()
    eps = float(np.finfo(dtype).eps)

    def norms(m):  # of each column, unscaled first (NumPy's norm does not scale)
        return np.linalg.norm(m / cols, axis=0)

    assert np.all(norms(a - q.T @ r) <= 20 * eps * norms(a))
    assert np.abs(q @ q.T - np.eye(p)).max() <= 20 * eps
    qn, rn = _numpy_qr(a)
    assert np.all(norms(r - rn) <= 20 * eps * norms(a))
    assert np.abs(q.T - qn).max() <= 20 * eps
    assert np.all(np.diag(r) >= 0) and np.array_equal(r, np.triu(r))


def test_tsqr_plan_tiles_and_levels():
    """The tile and the levels of T1's tree, and its launches: a QR pass a
    level below the root, the root, and an apply pass a level below it."""
    n = 10_485_760
    assert tsqr_plan(n, 8, 4) == TsqrPlan(8, 1024, (n, 81_920, 640))
    assert (tsqr_plan(n, 8, 4).launches(), tsqr_plan(n, 8, 4).launches(False)) == (5, 3)
    assert tsqr_plan(n, 4, 4) == TsqrPlan(4, 2048, (n, 20_480, 40))
    assert tsqr_plan(n, 16, 4) == TsqrPlan(16, 512, (n, 327_680, 10_240, 320))
    plan = tsqr_plan(n, 8, 8)
    assert plan == TsqrPlan(8, 512, (n, 163_840, 2_560, 40))
    assert (plan.launches(), plan.launches(False)) == (7, 4)
    assert [-(-rows // plan.tile) for rows in plan.levels] == [20_480, 320, 5, 1]
    assert tsqr_plan(1000, 3, 4) == TsqrPlan(4, 2048, (1000,))  # the root alone
    assert tsqr_plan(1000, 3, 4).launches() == tsqr_plan(1000, 3, 4).launches(False) == 1
    assert tsqr_plan(4100, 8, 4, n_chunks=9) == TsqrPlan(8, 456, (4100, 72))
    assert tsqr_plan(5000, 17, 4) == TsqrPlan(0, 64 * 17, (5000, 85))  # past MAX_P
    for bad in [dict(n=7, p=8, itemsize=4), dict(n=100, p=8, itemsize=4, n_chunks=7),
                dict(n=n, p=8, itemsize=4, n_chunks=8), dict(n=10, p=0, itemsize=4)]:
        with pytest.raises(ValueError, match="TSQR"):
            tsqr_plan(**bad)


def test_tsqr_rows_counts_calls_not_the_kernel_on_the_cpu(rng):
    tracing.reset()
    x = torch.from_numpy(rng.standard_normal((4, 300)))
    q, r = tsqr_rows(x)
    assert tsqr_rows(x, want_q=False)[0] is None
    assert tracing.counters() == {"tsqr.calls": 2}
    np.testing.assert_allclose((q.T @ r).numpy(), x.T.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["LA", "SA", "LM"])
def test_select_matches_jax(which):
    w = np.array([3.0, -7.0, 1.0, 5.0, -2.0, 5.0])
    got = eigs._select(torch.from_numpy(w), 4, which).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeigs._select(jnp.asarray(w), 4, which)))
    with pytest.raises(ValueError, match="which"):
        eigs._select(torch.from_numpy(w), 2, "BE")


# reorth="none" is left out: once the separated top converges, the bare
# recurrence amplifies rounding (ghost values), and two correct
# implementations part after a few more steps
@pytest.mark.parametrize("reorth", ["full", "selective"])
def test_lanczos_eigsh_matches_jax(reorth, rng):
    a, d = _spd(200, rng)
    b = rng.standard_normal(200)
    kw = dict(reorth=reorth, compute_vectors=True)
    vj, xj, rj = jeigs.lanczos_eigsh(JaxMatrix(jnp.asarray(a)), jnp.asarray(b),
                                     30, 4, **kw)
    vt, xt, rt = eigs.lanczos_eigsh(MatrixOperator(torch.from_numpy(a)),
                                    torch.from_numpy(b), 30, 4, **kw)
    _close(vt, vj, name="values")
    _close(rt, rj, 1e-8, name="bounds")
    _close(xt, xj, name="vectors")
    np.testing.assert_allclose(vt.numpy(), d[::-1][:4], rtol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(reorth="full"),
    dict(reorth="full", normalize="qr", eig_backend="lax"),
    dict(reorth="periodic", normalize="qr", breakdown_eps=1e-10),
    dict(reorth="full", eig_backend="newton", which="SA"),
])
def test_block_lanczos_eigsh_matches_jax(kw, rng):
    a, d = _spd(240, rng)
    b = rng.standard_normal((4, 240))
    vj, xj, rj = jeigs.block_lanczos_eigsh(
        JaxMatrix(jnp.asarray(a)), jnp.asarray(b), 8, 5, compute_vectors=True, **kw)
    vt, xt, rt = eigs.block_lanczos_eigsh(
        MatrixOperator(torch.from_numpy(a)), torch.from_numpy(b), 8, 5,
        compute_vectors=True, **kw)
    _close(vt, vj, name="values")
    _close(rt, rj, 1e-8, name="bounds")
    # a Ritz vector is defined up to its sign: align each pair first
    xt, xj = xt.numpy(), np.asarray(xj)
    xt = xt * np.sign(np.sum(xt * xj, axis=0))
    _close(xt, xj, name="vectors")
    if kw.get("which", "LA") == "LA":
        np.testing.assert_allclose(vt.numpy()[:3], d[::-1][:3], rtol=1e-10)


def test_ritz_residuals_match_jax_and_certify(rng):
    """The measured residuals of the port's pairs, as JAX computes them on
    the same pairs, for k not a multiple of 8 (the port pads no rows)."""
    a, _ = _spd(240, rng)
    b = rng.standard_normal((4, 240))
    op = MatrixOperator(torch.from_numpy(a))
    vals, vecs, _ = eigs.block_lanczos_eigsh(op, torch.from_numpy(b), 10, 5,
                                             compute_vectors=True)
    got = eigs.ritz_residuals(op, vals, vecs)
    want = jeigs.ritz_residuals(JaxMatrix(jnp.asarray(a)), jnp.asarray(vals.numpy()),
                                jnp.asarray(vecs.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    assert got.shape == (5,) and float(got[:3].max()) < 1e-8


def test_top_level_api_loads_lazily():
    import lanczos_tpu_torch as L

    assert L.block_lanczos_eigsh is eigs.block_lanczos_eigsh
    assert L.tsqr is tsqr
    assert "windowed_from_scipy" in dir(L)
    from lanczos_tpu_torch.parallel import dist_windowed

    assert L.halo_sharded_windowed is dist_windowed.halo_sharded_windowed
    assert L.HaloShardedWindowed is dist_windowed.HaloShardedWindowed
    with pytest.raises(AttributeError):
        L.no_such_name  # noqa: B018
