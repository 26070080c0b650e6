"""S1, the p x p Jacobi sqrtm / inv-sqrtm of the block recurrence
(`lanczos_tpu_torch/ops/kernels/smalleig.py`): its plain version against
the JAX package's `sqrtm_invsqrtm` (the jitted `jacobi_eigh`), its launch
plan, and the routing of `ops.smalleig.sqrtm_invsqrtm(backend="jacobi")`.
The kernel itself runs on the card only: tests/test_torch_kernels.py
holds it to the plain version there (`-m cuda`).

Tolerances, relative in the Frobenius norm: f64 1e-12 (both run the same
rotations in double precision; the p x p products sum in other orders);
f32 1e-5 on Grams of condition <= 1e3 (a rounding difference in a rotation
moves the inverse square root by about cond^(1/2) ulps); on a rank-
deficient Gram with breakdown_eps > 0 the pseudo-inverse as tightly, and
sqrtm to 1e-7 in f64: its zeroed eigenvalues are square roots of
rounding noise, sqrt(eps) of scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.ops import smalleig as jse
from lanczos_tpu_torch.ops import smalleig
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.smalleig import (
    MAX_P,
    MAX_THREADS,
    SqrtmPlan,
    jacobi_sqrtm,
    jacobi_sqrtm_plain,
    lineup,
    sqrtm_plan,
)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def spd(rng, p, cond=1e3, batch=()):
    q, _ = np.linalg.qr(rng.standard_normal(batch + (p, p)))
    w = np.geomspace(1.0, cond, p)
    return (q * w[..., None, :]) @ np.swapaxes(q, -1, -2)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def both(a, **kw):
    """(port's plain version, JAX) on the same array."""
    sq, inv = jacobi_sqrtm_plain(torch.from_numpy(a), **kw)
    kw = {"sweeps": kw.get("sweeps", 10), "breakdown_eps": kw.get("breakdown_eps", 0.0)}
    sj, ij = jse.sqrtm_invsqrtm(jnp.asarray(a), backend="jacobi", **kw)
    return (sq.numpy(), inv.numpy()), (np.asarray(sj), np.asarray(ij))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8, 18])
def test_plain_matches_jax(p, dtype, rng):
    a = spd(rng, p, batch=(2,)).astype(dtype)
    (sq, inv), (sj, ij) = both(a)
    assert sq.dtype == inv.dtype == dtype and sq.shape == a.shape
    assert rel(sq, sj) <= RTOL[dtype] and rel(inv, ij) <= RTOL[dtype]


@pytest.mark.parametrize("p", [4, 5])
def test_plain_matches_jax_at_16_sweeps(p, rng):
    """checkpoint.py passes its own sweep count."""
    a = spd(rng, p, batch=(3,))
    (sq, inv), (sj, ij) = both(a, sweeps=16)
    assert rel(sq, sj) <= 1e-12 and rel(inv, ij) <= 1e-12


@pytest.mark.parametrize("dtype,p,rank", [(np.float64, 4, 2), (np.float32, 5, 3)])
def test_plain_breakdown_pseudo_inverse_matches_jax(dtype, p, rank, rng):
    x = rng.standard_normal((2, p, rank))
    a = (x @ np.swapaxes(x, -1, -2)).astype(dtype)
    eps = 1e-8 if dtype == np.float64 else 1e-4
    (sq, inv), (sj, ij) = both(a, breakdown_eps=eps)
    assert np.isfinite(inv).all()
    assert rel(inv, ij) <= RTOL[dtype]
    assert rel(sq, sj) <= (1e-7 if dtype == np.float64 else 1e-3)


def test_plan_pads_odd_p_and_takes_one_thread_an_element():
    for itemsize in (2, 4, 8):
        for p in range(1, MAX_P + 1):
            plan = sqrtm_plan(p, itemsize)
            pp = p + p % 2
            assert plan == SqrtmPlan(pp, plan.threads, plan.smem)
            assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS
            assert plan.threads >= min(pp * pp, MAX_THREADS)
            # every thread holds at most the kernel's kSqrtmElems (4) elements
            assert -(-pp * pp // plan.threads) <= 4
            assert plan.smem == (3 * pp * pp + 2 * pp) * itemsize + 4 * pp
    assert sqrtm_plan(4, 4) == SqrtmPlan(4, 32, 240)
    assert sqrtm_plan(64, 8) == SqrtmPlan(64, 1024, 99584)  # past 48 KB: opt-in
    for p in (0, MAX_P + 1):
        with pytest.raises(ValueError, match="1 <= p <= 64"):
            sqrtm_plan(p, 4)


def test_lineup_is_the_round_robin_schedule():
    for pp in range(2, MAX_P + 1, 2):
        want = smalleig._round_robin_pairs(pp)
        got = [[(lineup(k, r, pp), lineup(pp - 1 - k, r, pp)) for k in range(pp // 2)]
               for r in range(pp - 1)]
        np.testing.assert_array_equal(np.asarray(got), want)


def test_sqrtm_invsqrtm_jacobi_routes_to_s1(monkeypatch, rng):
    """backend="jacobi" is S1: the plain version on a CPU tensor, no
    launch; a tensor on another device launches or raises, never falls
    back (here: the meta device)."""
    build.reset_launches()
    a = torch.from_numpy(spd(rng, 4, batch=(2,)))
    seen = []
    real = jacobi_sqrtm_plain

    def spy(x, sweeps, breakdown_eps):
        seen.append((sweeps, breakdown_eps))
        return real(x, sweeps, breakdown_eps)

    monkeypatch.setattr("lanczos_tpu_torch.ops.kernels.smalleig.jacobi_sqrtm_plain", spy)
    s, i = smalleig.sqrtm_invsqrtm(a, sweeps=7, breakdown_eps=1e-9)
    assert seen == [(7, 1e-9)]
    assert all(v == 0 for v in build.LAUNCHES.values())
    np.testing.assert_allclose((s @ i).numpy(), np.broadcast_to(np.eye(4), (2, 4, 4)),
                               atol=1e-10)
    with pytest.raises(ValueError, match="must be on"):
        jacobi_sqrtm(a.to("meta"))
    with pytest.raises(ValueError, match="1 <= p <= 64"):
        jacobi_sqrtm(torch.zeros((65, 65), device="meta"))
    with pytest.raises(ValueError, match="p, p"):
        jacobi_sqrtm(torch.zeros((3, 4)))
