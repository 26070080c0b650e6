"""The windowed-ELL operator of the port (ops/window_ell.py, the planner
and containers; ops/kernels/window_ell.py, K8's plain version) against the
JAX package's (lanczos_tpu/ops/pallas/window_ell.py, its Pallas kernel in
interpret mode on the CPU) and against scipy, on the fixtures of
tests/test_window_ell.py.

Tolerances:
- the planner's planes (`_pack_planes`, `_pack_planes_greedy`): bit-equal
  to JAX's (the same NumPy packing, before JAX's TPU-only pads);
- the SpMM in f32: 2e-6 of the result's scale against JAX's kernel and
  against scipy (both sum at most ~30 f32 products per row, in other
  orders);
- in f64: 1e-13 of scale against scipy (the JAX kernel sums f64 states in
  f32, so f64 is held to scipy only);
- the windowed eigsh end to end: 1e-3 relative against eigvalsh, as
  tests/test_window_ell.py:163 holds JAX.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lanczos_tpu.ops.pallas import window_ell as jwe
from lanczos_tpu_torch.ops import window_ell as twe
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.window_ell import (
    windowed_spmm,
    windowed_spmm_plain,
)

F32_RTOL = 2e-6
F64_RTOL = 1e-13
CPU = dict(device="cpu")


def _band(n, k=1):
    return sp.diags(
        [np.ones(n - abs(o)) * (2.0 if o == 0 else -1.0) for o in range(-k, k + 1)],
        list(range(-k, k + 1)),
        format="csr",
    )


def _fixture(name):
    """The matrices of tests/test_window_ell.py, with its plan options."""
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy

    if name == "tridiagonal":
        return _band(1000), {}
    if name == "997_rows":
        return _band(999)[:997, :999].tocsr(), {}
    if name == "wide_band":
        return _band(2000, k=5), {}
    if name == "band_plus_noise":
        d = sp.random(1200, 1200, density=0.003, random_state=1, format="csr")
        return (_band(1200) + d + d.T).tocsr(), dict(ppc_cap=128)
    if name == "unstructured":
        return sp.random(500, 500, density=0.02, random_state=2,
                         format="csr"), dict(ppc_cap=256)
    if name == "rectangular":
        return sp.random(300, 900, density=0.01, random_state=3,
                         format="csr"), dict(ppc_cap=128)
    if name == "laplacian_2d":
        return laplacian_2d_scipy(30, 30), {}
    if name == "rcm_band":
        perm = np.random.default_rng(5).permutation(1500)
        return _band(1500, k=3)[perm][:, perm].tocsr(), dict(reorder="rcm")
    raise KeyError(name)


FIXTURES = ["tridiagonal", "997_rows", "wide_band", "band_plus_noise",
            "unstructured", "rectangular", "laplacian_2d", "rcm_band"]


def _plans(name, dtype=torch.float32):
    a, kw = _fixture(name)
    a = a.astype(np.float32 if dtype == torch.float32 else np.float64)
    kw = dict(cpb=2, spg=2) | kw
    return a, kw


@functools.lru_cache(maxsize=None)
def _jax_plan(name):
    a, kw = _plans(name)
    return jwe.windowed_from_scipy(a, **kw)


def _x(n, p, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((p, n)).astype(dtype)


def _apply(A, X):
    """A X in the original ordering (a permuted plan is P A P^T)."""
    return A.unpermute(A.mm(A.permute(X)))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _csr(name):
    a, _ = _plans(name)
    a = a.tocsr()
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("name", FIXTURES)
def test_pack_planes_bit_equal_to_jax(name):
    a = _csr(name)
    n = a.shape[0]
    for pack in ("_pack_planes", "_pack_planes_greedy"):
        want = getattr(jwe, pack)(a.indptr, a.indices, a.data, n, 1 << 30)
        got = getattr(twe, pack)(a.indptr, a.indices, a.data, n, 1 << 30)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, pack
            np.testing.assert_array_equal(g, w, err_msg=pack)
    assert (twe._pack_planes_greedy(a.indptr, a.indices, a.data, n, 1 << 30,
                                    count_only=True)
            == jwe._pack_planes_greedy(a.indptr, a.indices, a.data, n, 1 << 30,
                                       count_only=True))


@pytest.mark.parametrize("name", FIXTURES)
def test_plan_geometry_matches_jax(name):
    """The same containers: planes per chunk (before JAX's TPU pad), band
    window, padded length, window bases and permutation."""
    a, kw = _plans(name)
    J, T = _jax_plan(name), twe.windowed_from_scipy(a, **kw, **CPU)
    assert (T.wsz, T.n128, T.ng, T.nnz, T.shape) == (J.wsz, J.n128, J.ng, J.nnz, J.shape)
    assert T.ppc <= J.ppc and (J.ppc - T.ppc) < 8
    np.testing.assert_array_equal(T.wb.numpy(), np.asarray(J.wb))
    np.testing.assert_array_equal(T.perm.numpy(), np.asarray(J.perm))
    assert T.planes_lidx.dtype == torch.uint8 and T.planes_off.dtype == torch.int32
    assert T.planes_data.shape == (T.n_chunks_pad * T.ppc, 128)


@pytest.mark.parametrize("name", FIXTURES)
def test_spmm_plain_matches_jax_kernel_f32(name):
    """K8's plain version, on the port's own plan and on JAX's arrays
    carried over by from_arrays, against JAX's Pallas kernel (interpret
    mode) and scipy: 2e-6 of scale."""
    a, kw = _plans(name)
    J = _jax_plan(name)
    X = _x(a.shape[1], 4)
    want = np.asarray(_apply(J, jnp.asarray(X)))
    ref = (a @ X.T.astype(np.float64)).T
    own = twe.windowed_from_scipy(a, **kw, **CPU)
    carried = twe.WindowedEllMatrix.from_arrays(
        *(np.asarray(x) for x in (J.planes_data, J.planes_lidx, J.planes_off,
                                  J.wb, J.perm)),
        n_rows_true=J.n_rows_true, n_cols_true=J.n_cols_true, ppc=J.ppc,
        cpb=J.cpb, spg=J.spg, wsz=J.wsz, n128=J.n128, nnz_true=J.nnz_true,
        interpret=J.interpret, **CPU,
    )
    assert carried.ppc == own.ppc
    for T in (own, carried):
        got = _apply(T, torch.from_numpy(X)).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_RTOL
        assert _rel(got, ref) <= F32_RTOL
    for buf in ("planes_data", "planes_lidx", "planes_off", "wb", "perm"):
        assert torch.equal(getattr(own, buf), getattr(carried, buf)), buf


@pytest.mark.parametrize("name", FIXTURES)
def test_spmm_plain_matches_scipy_f64(name):
    a, kw = _plans(name, torch.float64)
    T = twe.windowed_from_scipy(a, dtype=torch.float64, **kw, **CPU)
    assert T.dtype == torch.float64
    X = _x(a.shape[1], 3, dtype=np.float64)
    got = _apply(T, torch.from_numpy(X)).numpy()
    assert _rel(got, (a @ X.T).T) <= F64_RTOL
    dense = T.to_dense().numpy()
    if T.is_permuted:
        perm = T.perm.numpy()
        dense[np.ix_(perm, perm)] = dense.copy()
    np.testing.assert_allclose(dense, a.toarray(), rtol=0, atol=1e-15)


def test_padded_chain_keeps_the_pad_zero():
    """Padded states chain call to call; the pad region stays exactly zero
    and any p >= 1 works (no 8-row sublane pad)."""
    a = _band(600).astype(np.float64)
    A = twe.windowed_from_scipy(a, dtype=torch.float64, cpb=2, spg=2, **CPU)
    X = _x(600, 3, dtype=np.float64)
    Xp = A.pack(torch.from_numpy(X))
    assert Xp.shape == (3, A.n128)
    Y2 = A.padded_mm(A.padded_mm(Xp))
    assert torch.count_nonzero(Y2[:, 600:]) == 0
    np.testing.assert_allclose(A.unpack(Y2, 3).numpy(), (a @ (a @ X.T)).T,
                               rtol=0, atol=1e-12)
    op = twe.PaddedWindowedOperator(A)
    assert op.shape == (A.n128, A.n128)
    y = op.mv(Xp[1])
    assert y.shape == (A.n128,)
    np.testing.assert_allclose(y[:600].numpy(), a @ X[1], rtol=0, atol=1e-12)
    torch.testing.assert_close(op.mm(Xp), A.padded_mm(Xp), rtol=0, atol=0)


def test_mv_permute_roundtrip():
    a, kw = _plans("rcm_band", torch.float64)
    A = twe.windowed_from_scipy(a, dtype=torch.float64, **kw, **CPU)
    assert A.is_permuted
    x = torch.from_numpy(_x(1500, 1, dtype=np.float64)[0])
    y = A.unpermute(A.mv(A.permute(x)))
    np.testing.assert_allclose(y.numpy(), a @ x.numpy(), rtol=0, atol=1e-12)


def test_duplicates_sum_and_plan_error():
    rows, cols = np.array([0, 0, 5, 5, 5]), np.array([3, 3, 7, 7, 7])
    vals = np.array([1.0, 2.0, 1.0, 1.0, 1.0], np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(200, 200)).tocsr()
    A = twe.windowed_from_scipy(a, cpb=2, spg=2, **CPU)
    x = torch.zeros(200)
    x[3], x[7] = 1.0, 1.0
    y = A.mv(x)
    assert (y[0].item(), y[5].item()) == (3.0, 3.0)
    dense = sp.random(1000, 1000, density=0.05, random_state=6, format="csr")
    with pytest.raises(twe.PlanError):
        twe.windowed_from_scipy(dense, ppc_cap=4, **CPU)
    with pytest.raises(jwe.PlanError):
        jwe.windowed_from_scipy(dense.astype(np.float32), ppc_cap=4)


def test_from_ell_roundtrip():
    from lanczos_tpu_torch.ops.formats import ell_from_scipy

    a = _band(500, k=3)
    ell = ell_from_scipy(a, dtype=torch.float64, **CPU)
    A = twe.windowed_from_ell(ell, cpb=2, spg=2)
    assert A.dtype == torch.float64
    X = torch.from_numpy(_x(500, 4, dtype=np.float64))
    torch.testing.assert_close(A.mm(X), ell.mm(X), rtol=0, atol=1e-12)


def test_out_must_not_alias_x():
    A = twe.windowed_from_scipy(_band(300), cpb=2, spg=2, **CPU)
    X = A.pack(torch.ones((2, 300)))
    with pytest.raises(ValueError, match="alias"):
        windowed_spmm(A, X, X)
    # a partial overlap is an alias too; the next row is not
    shifted = X.view(-1)[64 : 64 + A.n128].view(1, -1)
    with pytest.raises(ValueError, match="alias"):
        windowed_spmm(A, X[:1], shifted)
    windowed_spmm(A, X[:1], X[1:])
    with pytest.raises(ValueError, match=r"\(p, "):
        windowed_spmm(A, torch.ones((2, 300)))
    out = torch.empty_like(X)
    assert windowed_spmm(A, X, out) is out
    torch.testing.assert_close(out, windowed_spmm_plain(A, X))


def test_cpu_tensors_take_the_plain_version():
    build.reset_launches()
    A = twe.windowed_from_scipy(_band(300), cpb=2, spg=2, **CPU)
    A.mm(torch.ones((2, 300)))
    assert build.LAUNCHES["windowed_spmm"] == 0


def test_builders_default_to_cuda():
    """Without a card, the cuda default raises; it never builds on the
    CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twe.windowed_from_scipy(_band(300))


def test_synthetic_matrix_matches_the_benchmark():
    """models/synthetic.py's copy gives the benchmark's CSR arrays."""
    from benchmarks.suitesparse_scale import synth_suitesparse_banded as ref
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded

    for n, seed in ((6000, 0), (20000, 3)):
        want, got = ref(n, seed), synth_suitesparse_banded(n, seed)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
        assert got.dtype == np.float32


def test_lanczos_end_to_end_windowed():
    """tests/test_window_ell.py:163 on the port: the windowed operator
    drives block-Lanczos eigsh (reorth full) to the top-3 of eigvalsh."""
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh

    spikes = np.zeros(400)
    spikes[:3] = [10.0, 8.0, 6.0]
    a = (_band(400) + sp.diags(spikes)).tocsr().astype(np.float32)
    A = twe.windowed_from_scipy(a, cpb=2, spg=2, **CPU)
    b = torch.from_numpy(_x(400, 4, seed=42))
    vals, _, _ = block_lanczos_eigsh(A, b, 12, 3, reorth="full")
    ref = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
    np.testing.assert_allclose(vals.numpy(), ref, rtol=1e-3)
