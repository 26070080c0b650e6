"""The port's small dense algebra (ops/smalleig.py, ops/tridiag.py)
against the JAX package's, on the same inputs.

Tolerances: f64 to ~1e-10 relative (both sides are backward-stable
solvers in double precision, run in different operation orders); f32
results are compared through the reconstruction they feed (sqrtm @
invsqrtm = I, V diag(w) V^T = A) to ~1e-5, since rotation-by-rotation
agreement is not a property of f32 Jacobi."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.ops import smalleig as jse
from lanczos_tpu.ops import tridiag as jtd
from lanczos_tpu_torch.ops import smalleig, tridiag


def _spd(rng, p, cond=1e3, batch=()):
    q, _ = np.linalg.qr(rng.standard_normal(batch + (p, p)))
    w = np.geomspace(1.0, cond, p)
    return (q * w[..., None, :]) @ np.swapaxes(q, -1, -2)


@pytest.mark.parametrize("p", [3, 4, 7])
def test_jacobi_eigh_matches_jax_f64(p, rng):
    a = _spd(rng, p, batch=(2,))
    wj, _ = jse.jacobi_eigh(jnp.asarray(a), sweeps=10)
    w, v = smalleig.jacobi_eigh(torch.from_numpy(a), sweeps=10)
    np.testing.assert_allclose(np.sort(w.numpy()), np.sort(np.asarray(wj)), rtol=1e-10)
    recon = (v * w[..., None, :]) @ v.transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), a, rtol=0, atol=1e-10 * np.abs(a).max())


@pytest.mark.parametrize("backend", ["jacobi", "newton", "lax"])
def test_sqrtm_invsqrtm_matches_jax_f64(backend, rng):
    a = _spd(rng, 4, batch=(3,))
    sj, ij = jse.sqrtm_invsqrtm(jnp.asarray(a), backend=backend)
    s, i = smalleig.sqrtm_invsqrtm(torch.from_numpy(a), backend=backend)
    for got, want in ((s, sj), (i, ij)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["jacobi", "newton", "lax"])
def test_sqrtm_invsqrtm_f32(backend, rng):
    a = _spd(rng, 4, cond=1e2).astype(np.float32)
    s, i = smalleig.sqrtm_invsqrtm(torch.from_numpy(a), backend=backend)
    assert s.dtype == torch.float32
    np.testing.assert_allclose((s @ s).numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose((s @ i).numpy(), np.eye(4), rtol=0, atol=1e-5)


def test_breakdown_eps_pseudo_inverse_matches_jax(rng):
    """A rank-2 Gram: the inverse zeroes the collapsed directions instead
    of dividing by ~0 (jacobi and lax agree with JAX); newton refuses."""
    x = rng.standard_normal((4, 2))
    a = x @ x.T
    for backend in ("jacobi", "lax"):
        sj, ij = jse.sqrtm_invsqrtm(jnp.asarray(a), backend=backend, breakdown_eps=1e-8)
        s, i = smalleig.sqrtm_invsqrtm(torch.from_numpy(a), backend=backend, breakdown_eps=1e-8)
        assert np.isfinite(i.numpy()).all()
        np.testing.assert_allclose(i.numpy(), np.asarray(ij), rtol=0, atol=1e-8 * np.abs(np.asarray(ij)).max())
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=1e-8 * np.abs(a).max())
    with pytest.raises(ValueError, match="newton"):
        smalleig.sqrtm_invsqrtm(torch.from_numpy(a), backend="newton", breakdown_eps=1e-8)


def test_expm_sym_matches_jax(rng):
    t = _spd(rng, 8, cond=10.0) - 3.0 * np.eye(8)
    want = np.asarray(jse.expm_sym(jnp.asarray(t)))
    got = smalleig.expm_sym(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_tridiagonal_assembly_matches_jax(rng):
    al, be = rng.standard_normal(5), rng.standard_normal(4)
    np.testing.assert_array_equal(
        tridiag.assemble_tridiagonal(torch.from_numpy(al), torch.from_numpy(be)).numpy(),
        np.asarray(jtd.assemble_tridiagonal(jnp.asarray(al), jnp.asarray(be))),
    )
    A, B = rng.standard_normal((4, 3, 3)), rng.standard_normal((3, 3, 3))
    np.testing.assert_array_equal(
        tridiag.assemble_block_tridiagonal(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
        np.asarray(jtd.assemble_block_tridiagonal(jnp.asarray(A), jnp.asarray(B))),
    )
