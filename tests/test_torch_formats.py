"""The port's sparse containers (lanczos_tpu_torch/ops/formats.py) against
the JAX package's (lanczos_tpu/ops/formats.py) and scipy, on the fixtures
of tests/test_formats.py: a random 93x93 matrix, the 11x11 2-D Laplacian
and the assembled Maxwell operator at 2x3x2.

Tolerances, relative to the result's scale: f64 1e-12 against scipy and
JAX (sums of a handful of products in other orders); f32 2e-6 against
JAX's f32 container (the same products in f32, summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lanczos_tpu.ops import formats as JF
from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
from lanczos_tpu_torch.models.maxwell import assemble_maxwell_A
from lanczos_tpu_torch.ops import formats as TF

F64_RTOL, F32_RTOL = 1e-12, 2e-6
CPU = dict(device="cpu")
TORCH_DT = {"float32": torch.float32, "float64": torch.float64}

BUILDERS = {
    "ell": (JF.ell_from_scipy, TF.ell_from_scipy),
    "csr": (JF.csr_from_scipy, TF.csr_from_scipy),
    "coo": (JF.coo_from_scipy, TF.coo_from_scipy),
    "dia": (JF.dia_from_scipy, TF.dia_from_scipy),
    "bsr": (lambda a, dtype: JF.bsr_from_scipy(a, block_size=4, dtype=dtype,
                                               engine="einsum"),
            lambda a, dtype, **kw: TF.bsr_from_scipy(a, block_size=4, dtype=dtype,
                                                     engine="einsum", **kw)),
}


def _case(name):
    if name == "random":
        return sp.random(93, 93, density=0.05,
                         random_state=np.random.RandomState(7)).tocsr()
    if name == "laplacian":
        return laplacian_2d_scipy(11)
    return assemble_maxwell_A(2, 3, 2)


def _both(fmt, a, dtype):
    jb, tb = BUILDERS[fmt]
    return jb(a, dtype=jnp.dtype(dtype)), tb(a, dtype=TORCH_DT[dtype], **CPU)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("fmt", sorted(BUILDERS))
@pytest.mark.parametrize("case", ["random", "laplacian", "maxwell"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mv_mm_match_jax_and_scipy(fmt, case, dtype, rng):
    a = _case(case)
    jm, tm = _both(fmt, a, dtype)
    assert tm.shape == jm.shape and tm.dtype == TORCH_DT[dtype]
    tol = F64_RTOL if dtype == "float64" else F32_RTOL
    x = rng.standard_normal(a.shape[1]).astype(dtype)
    X = rng.standard_normal((6, a.shape[1])).astype(dtype)
    for j_out, t_out, ref in (
        (jm.mv(jnp.asarray(x)), tm.mv(torch.from_numpy(x)), a @ x.astype(np.float64)),
        (jm.mm(jnp.asarray(X)), tm.mm(torch.from_numpy(X)),
         (a @ X.T.astype(np.float64)).T),
    ):
        got = t_out.numpy()
        assert got.shape == np.asarray(j_out).shape
        assert _rel(got, np.asarray(j_out)) <= tol
        assert _rel(got, ref) <= tol


@pytest.mark.parametrize("fmt", sorted(BUILDERS))
def test_from_arrays_carries_jax_containers(fmt, rng):
    """Each container rebuilt from the JAX container's arrays holds the
    port's own build's buffers, bit for bit, followed only by JAX's zero
    pad (its 8-row and 128-entry tiles; the port's builders do not pad)."""
    a = laplacian_2d_scipy(9)
    jm, tm = _both(fmt, a, "float64")
    cls = type(tm)
    if fmt == "ell":
        got = cls.from_arrays(np.asarray(jm.data), np.asarray(jm.indices),
                              *jm.shape, **CPU)
    elif fmt == "csr":
        got = cls.from_arrays(*(np.asarray(x) for x in (jm.indptr, jm.indices,
                                                        jm.data, jm.row_ids)),
                              *jm.shape, **CPU)
    elif fmt == "coo":
        got = cls.from_arrays(*(np.asarray(x) for x in (jm.rows, jm.cols, jm.data)),
                              *jm.shape, **CPU)
    elif fmt == "dia":
        got = cls.from_arrays(np.asarray(jm.data), jm.offsets, *jm.shape, **CPU)
    else:
        got = cls.from_arrays(np.asarray(jm.data), np.asarray(jm.block_cols),
                              *jm.shape, **CPU)
    assert type(got) is cls and got.shape == tm.shape
    for (name, b), (_, c) in zip(tm.named_buffers(), got.named_buffers()):
        lead = tuple(slice(0, s) for s in b.shape)
        assert b.ndim == c.ndim and torch.equal(c[lead], b), name
        pad = torch.ones_like(c, dtype=torch.bool)
        pad[lead] = False
        assert not c[pad].any(), name
    X = torch.from_numpy(rng.standard_normal((3, a.shape[1])))
    torch.testing.assert_close(got.mm(X), tm.mm(X), rtol=0, atol=0)


@pytest.mark.parametrize("fmt", sorted(BUILDERS))
def test_to_dense_roundtrip(fmt):
    a = sp.random(40, 37 if fmt != "dia" else 40, density=0.1,
                  random_state=np.random.RandomState(3)).tocsr()
    tm = BUILDERS[fmt][1](a, dtype=torch.float64, **CPU)
    np.testing.assert_allclose(tm.to_dense().numpy(), a.toarray(), rtol=0,
                               atol=1e-15)


def test_ell_diagonal_helpers_match_jax(rng):
    a = (sp.random(60, 60, density=0.1, random_state=np.random.RandomState(4))
         + sp.diags(rng.random(60) + 0.5)).tocsr()
    jm, tm = _both("ell", a, "float64")
    for fn in ("diagonal", "diag_inv", "diag_sqrt"):
        np.testing.assert_allclose(getattr(tm, fn)().numpy(),
                                   np.asarray(getattr(jm, fn)()), rtol=1e-15,
                                   err_msg=fn)
    np.testing.assert_allclose(tm.diagonal().numpy(), a.diagonal(), rtol=0)
    w = rng.standard_normal(60)
    scaled = tm.mult_diagonal(torch.from_numpy(w))
    np.testing.assert_allclose(scaled.to_dense().numpy(),
                               (a @ sp.diags(w)).toarray(), rtol=0, atol=1e-14)
    # a row wider than the requested width is refused, not truncated
    with pytest.raises(ValueError, match="width"):
        TF.ell_from_scipy(a, width=2, **CPU)


def test_bsr_engines_follow_jax():
    """engine='auto': windowed (K8) for f32, einsum for f64, as in JAX; the
    windowed face answers in the original ordering."""
    rng = np.random.default_rng(0)
    # block-tridiagonal (plans) and scattered blocks (JAX's plan fails: the
    # einsum fallback), each in both packages
    scattered = sp.random(40, 40, density=0.3, random_state=np.random.RandomState(2))
    scattered = sp.kron(scattered, rng.random((8, 8))).tocsr()
    assert (type(JF.bsr_from_scipy(scattered, block_size=8, dtype=jnp.float32)).__name__
            == type(TF.bsr_from_scipy(scattered, block_size=8, **CPU)).__name__
            == "BsrMatrix")
    tri = sp.diags([np.ones(39), np.full(40, 2.0), np.ones(39)], [-1, 0, 1])
    a = sp.kron(tri, rng.random((8, 8)))
    a = (a + a.T).tocsr()
    j32 = JF.bsr_from_scipy(a, block_size=8, dtype=jnp.float32)
    t32 = TF.bsr_from_scipy(a, block_size=8, dtype=torch.float32, **CPU)
    assert type(j32).__name__ == type(t32).__name__ == "BsrWindowedOperator"
    assert t32.nnz == a.nnz and t32.block_size == 8
    t64 = TF.bsr_from_scipy(a, block_size=8, dtype=torch.float64, **CPU)
    assert type(t64).__name__ == type(JF.bsr_from_scipy(
        a, block_size=8, dtype=jnp.float64)).__name__ == "BsrMatrix"
    X = rng.standard_normal((4, 320)).astype(np.float32)
    ref = (a @ X.T.astype(np.float64)).T
    # (JAX's windowed product is held to the port's in test_torch_window_ell.py)
    assert _rel(t32.mm(torch.from_numpy(X)).numpy(), ref) <= F32_RTOL
    np.testing.assert_allclose(t32.to_dense().numpy(), a.toarray(), rtol=1e-6)
    with pytest.raises(ValueError, match="engine"):
        TF.bsr_from_scipy(a, engine="pallas", **CPU)


@pytest.mark.parametrize("fmt", sorted(BUILDERS))
def test_builders_default_to_cuda(fmt):
    """No device given means the card; without one that is an error."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BUILDERS[fmt][1](laplacian_2d_scipy(4), dtype=torch.float32)
