"""Block Lanczos in the port (methods/block_lanczos*.py) against the JAX
package, on the Maxwell folded-plane operator at N=3 with a random start
block made by numpy: the fused recurrence in f32, where p >= 2 takes the
two-call mono step (in-place block_mix + stencil_gram), for m in
{2, 3, 5, 6} and p in {2, 4}, each p with an odd and an even m (JAX's two
scan splits).

f32 tolerance: 2e-5 of each coefficient array's scale.  The two sides
round differently (Gram sums in other orders, Jacobi rotations composed
in another order), and the fused recurrence derives its Grams through
p x p algebra that amplifies those roundings by ~||v||^2/||w||^2.

The materialized recurrence's re-orthogonalization modes (full, periodic,
selective) with sqrtm or TSQR normalization are held to JAX in f64 to
1e-10 of each array's scale on the ill-conditioned fixture of
tests/test_block_lanczos.py:203 (diag(geomspace(1, 1e8)), where the bare
recurrence loses orthogonality and selective reorth fires); measured
<= 6e-13.  replace_dead draws its noise from a torch.Generator, not JAX's
PRNG, so it is held to invariants: an orthonormal basis and Ritz values
on the spectrum, to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.block_lanczos import block_lanczos as jax_block_lanczos
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu_torch.methods import block_lanczos_fused
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu.ops.operator import MatrixOperator as JaxMatrix
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.operator import MatrixOperator
from lanczos_tpu_torch.ops.tridiag import assemble_block_tridiagonal

LC = 7
RTOL = {torch.float32: 2e-5, torch.float64: 1e-10}


def run_both(p, m, dtype, fused, seed=0, n=3):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jop = JaxOp.create(n, n, n, dtype=jdt)
    top = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device="cpu")
    x = np.random.default_rng(seed).standard_normal((p, top.n))
    b = top.pack(torch.from_numpy(x).to(dtype))
    rj = jax_block_lanczos(jop, jnp.asarray(b.numpy()), m, 0,
                           trace_fn=jop.trace_fn(LC), fused=fused)
    rt = block_lanczos(top, b, m, 0, trace_fn=top.trace_fn(LC), fused=fused)
    return rj, rt


def assert_results_close(rj, rt, dtype, m, p):
    for name in ("alphas", "betas", "trace", "beta_final"):
        want = np.asarray(getattr(rj, name))
        got = getattr(rt, name)
        assert got.dtype == dtype
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=RTOL[dtype] * max(np.abs(want).max(), 1e-30), err_msg=name,
        )
    assert rt.alphas.shape == (m, p, p)
    assert not bool(rt.breakdown)


# m in {2, 3, 5, 6}, each p with an odd and an even m
@pytest.mark.parametrize("p,m", [(2, 2), (2, 5), (4, 3), (4, 6)])
def test_fused_mono_matches_jax_f32(p, m):
    rj, rt = run_both(p, m, torch.float32, fused=True)
    assert_results_close(rj, rt, torch.float32, m, p)


def test_fused_f32_takes_the_mono_step(monkeypatch):
    """p >= 2 in f32: every step from j=2 on calls stencil_gram once and
    block_mix in place; the trace of q0 survives q0's buffer being reused."""
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    calls = []
    real = top.stencil_gram
    monkeypatch.setattr(top, "stencil_gram", lambda q, d: calls.append(1) or real(q, d))
    x = np.random.default_rng(0).standard_normal((4, top.n)).astype(np.float32)
    b = top.pack(torch.from_numpy(x))
    res = block_lanczos(top, b, 6, 0, trace_fn=top.trace_fn(LC), fused=True)
    assert len(calls) == 6 - 2
    ref = block_lanczos(top, b, 6, 0, trace_fn=top.trace_fn(LC), fused=False)
    np.testing.assert_allclose(res.trace.numpy(), ref.trace.numpy(), rtol=0,
                               atol=1e-4 * np.abs(ref.trace.numpy()).max())


def test_auto_dispatch_uses_the_16mb_gate(monkeypatch):
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    b = top.pack(torch.ones((2, top.n)))
    taken = []
    real = block_lanczos_fused.block_lanczos_fused
    monkeypatch.setattr(block_lanczos_fused, "block_lanczos_fused",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    block_lanczos(top, b, 2, 0, trace_fn=top.trace_fn(LC))  # 98 KB: materialized
    assert taken == []
    monkeypatch.setattr("lanczos_tpu_torch.methods.block_lanczos.FUSED_GATE_BYTES",
                        b.numel() * b.element_size())
    block_lanczos(top, b, 2, 0, trace_fn=top.trace_fn(LC))  # at the gate: fused
    assert taken == [1]


@pytest.mark.parametrize("fused", [True, False])
def test_breakdown_tol_freezes_the_recurrence(fused):
    """rcond = 1/(||inv|| ||beta||) <= 1/p < 1 always, so a tolerance of 1
    freezes at the first step: zero alpha/beta/trace rows after it, the
    breakdown flag set, beta_final zeroed — in both recurrences."""
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    x = np.random.default_rng(0).standard_normal((2, top.n)).astype(np.float32)
    b = top.pack(torch.from_numpy(x))
    res = block_lanczos(top, b, 4, 0, trace_fn=top.trace_fn(LC), fused=fused,
                        breakdown_tol=1.0)
    assert bool(res.breakdown)
    assert torch.count_nonzero(res.betas[1:]) == 0
    assert torch.count_nonzero(res.alphas[1:]) == 0
    assert torch.count_nonzero(res.trace[1:]) == 0
    assert torch.count_nonzero(res.beta_final) == 0
    assert torch.count_nonzero(res.betas[0]) > 0


def test_state_trace_reads_one_element_per_column():
    from lanczos_tpu_torch.ops.operator import state_trace

    q = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    flat = q.reshape(2, -1)
    for lc in (0, 7, 59):
        tr = state_trace(q, lc, block=True)
        assert torch.equal(tr, flat[:, lc])
        assert torch.equal(state_trace(q[1], lc, block=False), flat[1, lc])
    q.zero_()  # a copy, not a view
    assert torch.equal(tr, torch.tensor([59.0, 119.0]))


@pytest.mark.parametrize("kw,match", [
    (dict(fused=False), "fused=False contradicts it"),
    (dict(reorth="full"), "implemented on the fused path"),
    (dict(normalize="qr"), "implemented on the fused path"),
    (dict(replace_dead=True), "implemented on the fused path"),
])
def test_compensated_needs_the_fused_path(kw, match):
    """JAX block_lanczos.py:176-188: compensated=True exists on the fused
    path only, so fused=False or a non-fusable mode is a ValueError."""
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    b = top.pack(torch.ones((2, top.n)))
    with pytest.raises(ValueError, match=match):
        block_lanczos(top, b, 2, 0, compensated=True, **kw)


def test_compensated_routes_to_the_fused_3call_step(monkeypatch):
    """compensated=True takes the fused route below the 16 MB gate, takes
    every Gram from K7 and none from K3, and runs no mono step (K4)."""
    from lanczos_tpu_torch.ops.kernels import block_dense

    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    calls = {"comp": 0, "grams": 0, "stencil_gram": 0}

    def counted(key, fn):
        return lambda *a, **k: calls.__setitem__(key, calls[key] + 1) or fn(*a, **k)

    monkeypatch.setattr(block_lanczos_fused, "block_grams_compensated",
                        counted("comp", block_dense.block_grams_compensated))
    monkeypatch.setattr(block_lanczos_fused, "block_grams",
                        counted("grams", block_dense.block_grams))
    monkeypatch.setattr(top, "stencil_gram", counted("stencil_gram", top.stencil_gram))
    x = np.random.default_rng(0).standard_normal((4, top.n)).astype(np.float32)
    b = top.pack(torch.from_numpy(x))
    res = block_lanczos(top, b, 6, 0, trace_fn=top.trace_fn(LC), compensated=True)
    assert calls == {"comp": 6 + 1, "grams": 0, "stencil_gram": 0}
    ref = block_lanczos(top, b, 6, 0, trace_fn=top.trace_fn(LC), fused=False)
    np.testing.assert_allclose(res.trace.numpy(), ref.trace.numpy(), rtol=0,
                               atol=1e-4 * np.abs(ref.trace.numpy()).max())


@pytest.mark.parametrize("fused", [True, False])
def test_store_basis_keeps_every_block(fused):
    """store_basis turns the mono step off (its in-place block_mix reuses
    q_{j-2}'s buffer) and returns the m blocks, orthonormal and matching
    the trace."""
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(0).standard_normal((2, top.n))
    b = top.pack(torch.from_numpy(x))
    res = block_lanczos(top, b, 5, 0, trace_fn=top.trace_fn(LC), fused=fused,
                        store_basis=True)
    q = res.basis.reshape(5 * 2, -1).numpy()
    np.testing.assert_allclose(q @ q.T, np.eye(10), atol=1e-10)
    torch.testing.assert_close(top.trace_fn(LC)(res.basis), res.trace, rtol=0, atol=0)
    assert block_lanczos(top, b, 5, 0, fused=fused).basis is None


@pytest.mark.parametrize("extra", [{}, dict(breakdown_eps=1e-10)])
@pytest.mark.parametrize("normalize", ["sqrtm", "qr"])
@pytest.mark.parametrize("reorth", ["full", "periodic", "selective"])
def test_reorth_and_qr_match_jax_f64(reorth, normalize, extra):
    n, p, m = 300, 4, 24
    a = np.diag(np.geomspace(1, 1e8, n))
    b = np.random.default_rng(1234).standard_normal((p, n))
    kw = dict(reorth=reorth, normalize=normalize, eig_backend="lax",
              store_basis=True, **extra)
    rj = jax_block_lanczos(JaxMatrix(jnp.asarray(a)), jnp.asarray(b), m, **kw)
    rt = block_lanczos(MatrixOperator(torch.from_numpy(a)), torch.from_numpy(b),
                       m, **kw)
    for name in ("alphas", "betas", "beta_final", "trace", "basis"):
        want, got = np.asarray(getattr(rj, name)), getattr(rt, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max(), err_msg=name)
    q = rt.basis.reshape(m * p, n).numpy()
    assert np.abs(q @ q.T - np.eye(m * p)).max() < 1e-12


def test_selective_fires_on_the_fixture(monkeypatch):
    """The selective comparison above is not vacuous: the omega estimate
    triggers the cleanup, so CGS2 runs on some steps but not all."""
    from lanczos_tpu_torch.methods import block_lanczos as bl

    calls = []
    real = bl._cgs2
    monkeypatch.setattr(bl, "_cgs2", lambda w, q: calls.append(1) or real(w, q))
    a = torch.from_numpy(np.diag(np.geomspace(1, 1e8, 300)))
    b = torch.from_numpy(np.random.default_rng(1234).standard_normal((4, 300)))
    bl.block_lanczos(MatrixOperator(a), b, 24, reorth="selective",
                     eig_backend="lax")
    # two passes (q-side, residual) per cleanup, on fewer than all steps
    assert 0 < len(calls) < 2 * 23


def _replace_dead_fixture():
    """A start column inside a 3-dimensional invariant subspace: its
    direction collapses at the third step."""
    rng = np.random.default_rng(1234)
    n, p = 300, 4
    d = np.linspace(1.0, 100.0, n)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * d) @ q.T
    b = rng.standard_normal((p, n))
    b[0] = q[:, -3:] @ rng.standard_normal(3)
    return a, b, d


def _replace_dead_run(replace_dead, m=10):
    a, b, d = _replace_dead_fixture()
    res = block_lanczos(MatrixOperator(torch.from_numpy(a)), torch.from_numpy(b),
                        m, reorth="full", normalize="qr", breakdown_eps=1e-8,
                        replace_dead=replace_dead, store_basis=True)
    w = np.linalg.eigvalsh(
        assemble_block_tridiagonal(res.alphas, res.betas[1:]).numpy())
    return res, res.basis.reshape(m * 4, -1).numpy(), w, d


def test_replace_dead_invariants():
    """replace_dead refills the direction that collapsed at the third step
    (its beta row zeroed) with a fresh basis-orthogonal unit direction: the
    basis stays orthonormal at full width, the Ritz values lie on the
    spectrum and the top three are exact, to 1e-10."""
    res, q, w, d = _replace_dead_run(True)
    assert torch.count_nonzero(res.betas[3].abs().sum(dim=1) == 0) == 1
    np.testing.assert_allclose(q @ q.T, np.eye(q.shape[0]), rtol=0, atol=1e-10)
    assert w.max() <= d.max() * (1 + 1e-10) and w.min() >= d.min() * (1 - 1e-10)
    np.testing.assert_allclose(w[-3:], d[-3:], rtol=1e-10)


def test_deflation_without_replace_dead_zeroes_the_direction():
    """Without replace_dead the collapsed direction is deflated: its beta
    row and its basis column stay zero from then on (JAX's deflation mode,
    whose later steps lose orthogonality in both packages alike), and the
    converged top three are exact."""
    res, q, w, d = _replace_dead_run(False)
    assert torch.count_nonzero(res.betas[3].abs().sum(dim=1) == 0) == 1
    norms = np.linalg.norm(q, axis=1)
    assert np.sum(norms < 1e-12) == 10 - 3 and np.all(norms[:12] > 0.5)
    np.testing.assert_allclose(w[-3:], d[-3:], rtol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(normalize="sqrtm", breakdown_eps=1e-8, reorth="full"),
    dict(normalize="qr", breakdown_eps=0.0, reorth="full"),
    dict(normalize="qr", breakdown_eps=1e-8, reorth="none"),
])
def test_replace_dead_needs_qr_eps_and_a_basis(kw):
    """JAX's checks (block_lanczos.py:206-212)."""
    a, b, _ = _replace_dead_fixture()
    with pytest.raises(ValueError, match="replace_dead"):
        block_lanczos(MatrixOperator(torch.from_numpy(a)), torch.from_numpy(b),
                      4, replace_dead=True, **kw)
