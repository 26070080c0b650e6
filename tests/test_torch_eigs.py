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
from lanczos_tpu_torch.ops.operator import MatrixOperator
from lanczos_tpu_torch.ops.tsqr import tsqr

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
    with pytest.raises(AttributeError):
        L.halo_sharded_windowed  # noqa: B018  (multi-device: not ported)
