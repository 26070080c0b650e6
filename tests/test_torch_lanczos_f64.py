"""Block Lanczos, the expm actions and the FDTD oracle in the port against
the JAX package: the fused recurrence in f64 (stencil_gram is f32-only in
both packages, so every step from j=2 on is the 3-call step), the
materialized recurrence, `block_lanczos_expm_action`,
`lanczos_expm_action`, and `fdtd_vector`/`fdtd_block` on the folded-plane
operator (the one-pass step, K5's plain version) and on the flat-state
operator (u + dt A u).

f64 agrees to 1e-10 relative (rounding in different operation orders);
f32 as in test_torch_lanczos.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.expm_action import (
    block_lanczos_expm_action as jax_expm_action,
)
from lanczos_tpu.methods.expm_action import (
    lanczos_expm_action as jax_vector_expm_action,
)
from lanczos_tpu.methods.fdtd import fdtd_block as jax_fdtd_block
from lanczos_tpu.methods.fdtd import fdtd_vector as jax_fdtd_vector
from lanczos_tpu.models.maxwell import MaxwellOperator as JaxMaxwell
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu_torch.methods.expm_action import (
    block_lanczos_expm_action,
    lanczos_expm_action,
)
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.models.maxwell import MaxwellOperator
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from tests.test_torch_lanczos import LC, assert_results_close, run_both


@pytest.mark.parametrize("p,m", [(2, 6), (4, 3)])
def test_fused_3call_matches_jax_f64(p, m):
    rj, rt = run_both(p, m, torch.float64, fused=True)
    assert_results_close(rj, rt, torch.float64, m, p)


@pytest.mark.parametrize("p,m,dtype", [
    (4, 3, torch.float32), (4, 6, torch.float32), (2, 5, torch.float64),
])
def test_materialized_matches_jax(p, m, dtype):
    rj, rt = run_both(p, m, dtype, fused=False)
    assert_results_close(rj, rt, dtype, m, p)


def _fixture(p, dtype, seed=3):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jop = JaxOp.create(3, 3, 3, dtype=jdt)
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=dtype, device="cpu")
    x = np.random.default_rng(seed).standard_normal((p, top.n))
    b = top.pack(torch.from_numpy(x).to(dtype))
    return jop, top, b


@pytest.mark.parametrize("fused", [True, False])
def test_block_expm_action_matches_jax_f64(fused):
    jop, top, b = _fixture(2, torch.float64)
    want = np.asarray(jax_expm_action(jop, jnp.asarray(b.numpy()), 5, 1.0, 0,
                                      trace_fn=jop.trace_fn(LC), fused=fused))
    got = block_lanczos_expm_action(top, b, 5, 1.0, 0,
                                    trace_fn=top.trace_fn(LC), fused=fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    # the single-vector action of the first column, on the same route
    want1 = float(jax_vector_expm_action(jop, jnp.asarray(b[0].numpy()), 5, 1.0,
                                         0, trace_fn=jop.trace_fn(LC),
                                         fused=fused))
    got1 = lanczos_expm_action(top, b[0], 5, 1.0, 0, trace_fn=top.trace_fn(LC),
                               fused=fused)
    assert got1.shape == () and abs(float(got1) - want1) <= 1e-10 * abs(want1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fdtd_block_matches_jax(dtype):
    """300 forward-Euler steps with dt folded into the weights: f32 agrees
    to 1e-5 of the state's scale (the per-step operator rounding does not
    grow: ||dt*A|| << 1), f64 to 1e-12."""
    jop, top, b = _fixture(3, dtype)
    want = np.asarray(jax_fdtd_block(jop, jnp.asarray(b.numpy()), 300, 1.0))
    got = fdtd_block(top, b, 300, 1.0)
    assert not torch.equal(got, b) and got.data_ptr() != b.data_ptr()
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("n,p", [(6, 1), (10, 2), (6, 4)])
def test_fdtd_one_pass_step_matches_jax(n, p, monkeypatch):
    """tests/test_stencil_gram.py:113-139's fixture (12 chained steps,
    t_end 0.5), plus p=4: the port takes its one-pass step (K5's plain
    version) at every p, JAX its in-place Pallas kernel at p <= 2 and the
    two-pass step at p=4.  f32 to 2e-5, the JAX test's bound.  The loop
    swaps two buffers of its own: u0 is only read."""
    jop = JaxOp.create(n, n, n, dtype=jnp.float32)
    top = PallasMaxwellOperator.create(n, n, n, device="cpu")
    x = np.random.default_rng(p).standard_normal((p, top.n)).astype(np.float32)
    u0 = top.pack(torch.from_numpy(x))
    steps = []
    real = PallasMaxwellOperator.fdtd_step
    monkeypatch.setattr(PallasMaxwellOperator, "fdtd_step",
                        lambda self, u, out: steps.append(1) or real(self, u, out))
    if p == 1:
        want = np.asarray(jax_fdtd_vector(jop, jnp.asarray(u0[0].numpy()), 12, 0.5))
        got = fdtd_vector(top, u0[0].clone(), 12, 0.5)
    else:
        want = np.asarray(jax_fdtd_block(jop, jnp.asarray(u0.numpy()), 12, 0.5))
        got = fdtd_block(top, u0, 12, 0.5)
    assert len(steps) == 12
    assert torch.equal(u0, top.pack(torch.from_numpy(x)))
    assert got.data_ptr() != u0.data_ptr()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("block", [False, True])
def test_fdtd_on_the_flat_operator_matches_jax_f64(block):
    """MaxwellOperator has no `scaled`: both packages step u + dt (A u)
    (JAX `_maybe_fold_dt`), 300 steps, f64 to 1e-12."""
    jop = JaxMaxwell.create(3, 3, 3, dtype=jnp.float64)
    top = MaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, top.n))
    if block:
        want = np.asarray(jax_fdtd_block(jop, jnp.asarray(x), 300, 1.0))
        got = fdtd_block(top, torch.from_numpy(x), 300, 1.0).numpy()
    else:
        want = np.asarray(jax_fdtd_vector(jop, jnp.asarray(x[0]), 300, 1.0))
        got = fdtd_vector(top, torch.from_numpy(x[0]), 300, 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
