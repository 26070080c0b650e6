"""Block Lanczos, the expm action and the FDTD oracle in the port against
the JAX package: the fused recurrence in f64 (stencil_gram is f32-only in
both packages, so every step from j=2 on is the 3-call step), the
materialized recurrence, `block_lanczos_expm_action` and `fdtd_block`.

f64 agrees to 1e-10 relative (rounding in different operation orders);
f32 as in test_torch_lanczos.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.expm_action import (
    block_lanczos_expm_action as jax_expm_action,
)
from lanczos_tpu.methods.fdtd import fdtd_block as jax_fdtd_block
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu_torch.methods.expm_action import (
    block_lanczos_expm_action,
    lanczos_expm_action,
)
from lanczos_tpu_torch.methods.fdtd import fdtd_block
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
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=dtype)
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        lanczos_expm_action(top, b[0], 5, 1.0, LC)


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
