"""Single-vector Lanczos and the vector expm action in the port
(methods/vector_lanczos.py, methods/expm_action.py) against the JAX
package, on the CPU, with inputs made by numpy: the classic recurrence
under reorth none/full/selective, the fused route at block width 1
(fused True/None/False), store_basis, the breakdown freeze, and the expm
action on the flat-state Maxwell operator against the dense expm.

Tolerances, relative to each array's largest |value|:
- f64, 1e-11: the JAX tests' own bound for these fixtures (rounding in
  other operation orders).
- f32, 1e-5 for the classic recurrence: a single start vector has none of
  the block fixture's collinearity, so both sides sit within a few ulps of
  f32 of each other.  The fused route derives alpha from deferred Grams,
  which amplify rounding (test_torch_lanczos.py's 2e-5): there JAX's f32
  alphas sit 1.4e-5 from the f64 answer and the port's 5.7e-7 (measured
  on a CPU), so the port is held to 2e-5 of JAX and to no farther
  from f64 than JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.vector_lanczos import vector_lanczos as jax_vector_lanczos
from lanczos_tpu.ops.operator import MatrixOperator as JaxMatrix
from lanczos_tpu_torch.methods import block_lanczos_fused
from lanczos_tpu_torch.methods.expm_action import lanczos_expm_action
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.models.maxwell import MaxwellOperator, assemble_maxwell_A
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.models.rhs import gaussian_vector_b
from lanczos_tpu_torch.ops.operator import MatrixOperator

RTOL = {np.float64: 1e-11, np.float32: 1e-5}
NAMES = ("alphas", "betas", "trace", "beta_final")


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / np.sqrt(n)


def run_both(a, b, m, **kw):
    rj = jax_vector_lanczos(JaxMatrix(jnp.asarray(a)), jnp.asarray(b), m, **kw)
    rt = vector_lanczos(MatrixOperator(torch.from_numpy(a)), torch.from_numpy(b),
                        m, **kw)
    return rj, rt


def assert_close(rj, rt, dtype, names=NAMES, rtol=None):
    rtol = rtol or RTOL[dtype]
    for name in names:
        want = np.asarray(getattr(rj, name))
        got = getattr(rt, name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(
            got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300),
            err_msg=name,
        )
    assert bool(rt.breakdown) == bool(rj.breakdown)


@pytest.mark.parametrize("reorth,fused", [
    ("none", False), ("none", True), ("none", None),
    ("full", False), ("full", None), ("selective", False),
])
def test_vector_lanczos_matches_jax_f64(reorth, fused):
    """The fixture of tests/test_block_dense.py:247-263 (n=512, m=10), with
    the basis kept."""
    a = _sym(512)
    b = np.random.default_rng(1).standard_normal(512)
    rj, rt = run_both(a, b, 10, lc=7, reorth=reorth, fused=fused,
                      store_basis=True)
    assert_close(rj, rt, np.float64, NAMES + ("basis",))
    np.testing.assert_allclose(rt.trace.numpy(), rt.basis[:, 7].numpy(), atol=1e-14)


@pytest.mark.parametrize("fused", [True, False])
def test_vector_lanczos_matches_jax_f32(fused):
    a = _sym(384, seed=2)
    b = np.random.default_rng(3).standard_normal(384)
    exact = np.asarray(run_both(a, b, 8, lc=5, fused=False)[0].alphas)
    rj, rt = run_both(a.astype(np.float32), b.astype(np.float32), 8, lc=5,
                      fused=fused)
    assert_close(rj, rt, np.float32, rtol=2e-5 if fused else None)
    port_err = np.abs(rt.alphas.numpy() - exact).max()
    jax_err = np.abs(np.asarray(rj.alphas) - exact).max()
    assert port_err <= jax_err + 1e-6 * np.abs(exact).max()


@pytest.mark.parametrize("reorth", ["none", "full", "selective"])
def test_orthogonality_matches_jax(reorth):
    """tests/test_vector_lanczos.py's fixture: a diagonal with a 1e6
    spread, n=300, m=60.  The bare recurrence loses orthogonality (both
    packages); full and selective keep it to 1e-8, and there the two
    packages' coefficients agree to 1e-11 (the same steps reorthogonalize:
    selective's omega estimate makes the same decisions on both sides)."""
    n, m = 300, 60
    a = np.diag(np.geomspace(1, 1e6, n))
    b = np.random.default_rng(1234).standard_normal(n)
    rj, rt = run_both(a, b, m, reorth=reorth, store_basis=True)
    q = rt.basis.numpy()
    err = np.abs(q @ q.T - np.eye(m)).max()
    if reorth == "none":
        assert err > 1e-4
    else:
        assert err < 1e-8
        assert_close(rj, rt, np.float64)


def test_breakdown_freezes_like_jax():
    """Start in an eigenvector: the Krylov space is one-dimensional, the
    recurrence freezes, betas[1:] are zero and nothing is NaN."""
    a = np.diag([1.0, 2.0, 3.0, 4.0])
    b = np.array([1.0, 0.0, 0.0, 0.0])
    rj, rt = run_both(a, b, 4, breakdown_tol=1e-12)
    assert bool(rt.breakdown)
    assert torch.all(torch.isfinite(rt.alphas))
    assert torch.count_nonzero(rt.betas[1:]) == 0
    assert_close(rj, rt, np.float64)


def test_fused_route_needs_a_bare_run():
    a = MatrixOperator(torch.from_numpy(_sym(16)))
    b = torch.ones(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused=True"):
        vector_lanczos(a, b, 3, fused=True, reorth="full")
    with pytest.raises(ValueError, match="fused=True"):
        vector_lanczos(a, b, 3, fused=True, breakdown_tol=1e-3)
    with pytest.raises(ValueError, match="reorth"):
        vector_lanczos(a, b, 3, reorth="periodic")


def test_auto_dispatch_uses_the_16mb_gate(monkeypatch):
    top = PallasMaxwellOperator.create(3, 3, 3)
    b = top.pack(torch.ones(top.n))
    taken = []
    real = block_lanczos_fused.block_lanczos_fused
    monkeypatch.setattr(block_lanczos_fused, "block_lanczos_fused",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    vector_lanczos(top, b, 2, 0, trace_fn=top.trace_fn(7))
    assert taken == []
    monkeypatch.setattr("lanczos_tpu_torch.methods.vector_lanczos.FUSED_GATE_BYTES",
                        b.numel() * b.element_size())
    vector_lanczos(top, b, 2, 0, trace_fn=top.trace_fn(7))
    assert taken == [1]


def test_fused_route_calls_each_kernel_once_per_step(monkeypatch):
    """The vector slice's route on the folded-plane operator: per step one
    block_mix (K2), one A q (K1) and one block_grams (K3), and no
    stencil_gram (K4: mono needs p >= 2).  The counts the H100 smoke
    expects at m=8: K1 8, K2 8, K3 9."""
    top = PallasMaxwellOperator.create(3, 3, 3)
    calls = {"mix": 0, "grams": 0, "mm": 0, "stencil_gram": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(block_lanczos_fused, "block_mix",
                        counted("mix", block_lanczos_fused.block_mix))
    monkeypatch.setattr(block_lanczos_fused, "block_grams",
                        counted("grams", block_lanczos_fused.block_grams))
    monkeypatch.setattr(top, "mm", counted("mm", top.mm))
    monkeypatch.setattr(top, "stencil_gram",
                        counted("stencil_gram", top.stencil_gram))
    x = np.random.default_rng(0).standard_normal(top.n).astype(np.float32)
    vector_lanczos(top, top.pack(torch.from_numpy(x)), 8, 0,
                   trace_fn=top.trace_fn(7), fused=True)
    assert calls == {"mix": 8, "grams": 9, "mm": 8, "stencil_gram": 0}


def test_expm_action_convergence_on_maxwell():
    """tests/test_vector_lanczos.py:113-140: the N=3 Maxwell problem (n =
    252) in f64 against the dense expm; the error falls with m and
    plateaus near 1e-10."""
    from scipy.linalg import expm as scipy_expm

    op = MaxwellOperator.create(3, 3, 3, dtype=torch.float64)
    b = gaussian_vector_b(3, op.n)
    lc = 20
    exact = (scipy_expm(assemble_maxwell_A(3, 3, 3).toarray()) @ b)[lc]
    errs = {}
    for m in (1, 2, 4, 6, 8):
        sol = float(lanczos_expm_action(op, torch.from_numpy(b), m, 1.0, lc))
        errs[m] = abs(sol - exact) / abs(exact)
    assert errs[1] > errs[2] > errs[4] > errs[6]
    assert errs[2] < 1e-1
    assert errs[4] < 1e-4
    assert errs[6] < 1e-8
    assert errs[8] < 1e-10
