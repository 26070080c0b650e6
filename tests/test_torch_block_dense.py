"""K2 (block_mix), K3 (block_grams), K4 (apply_stencil_pair_gram) and K7
(block_grams_compensated): the port's wrappers on CPU tensors (their plain
torch versions) against the JAX package's Pallas kernels in interpret
mode, on the folded-plane Maxwell state (p, 6, Zc, P) and, for K7, on the
flat states of the JAX package's own K7 tests (its interpret-mode kernel
takes minutes to trace on a folded-plane state)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.block_lanczos import block_lanczos as jax_block_lanczos
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu.ops.operator import MatrixOperator as JaxMatrix
from lanczos_tpu.ops.pallas import block_dense as jbd
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.operator import MatrixOperator
from lanczos_tpu_torch.ops.kernels import block_dense, stencil_gram

# Tolerances, relative to the largest |value| of the result: both sides
# accumulate in the state's type but in different orders (XLA's dot vs
# torch's matmul), so f32 agrees to a few hundred ulps of a sum over the
# ~12k-element state, f64 to rounding.
RTOL = {np.float32: 2e-6, np.float64: 1e-13}


def _state(rng, p, dtype, n=6):
    top = PallasMaxwellOperator.create(n, n, n, device="cpu")
    x = rng.standard_normal((p, top.n))
    return np.asarray(top.pack(torch.from_numpy(x)).numpy(), dtype)


def _close(got, want, dtype):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows", [(4,), (4, 4), (4, 4, 4), (2, 3, 1)])
def test_block_mix_matches_jax(rows, dtype, rng):
    xs = [_state(rng, r, dtype) for r in rows]
    coeffs = rng.standard_normal((sum(rows), 3)).astype(dtype)
    want = np.asarray(jbd.block_mix(jnp.asarray(coeffs), [jnp.asarray(x) for x in xs]))
    got = block_dense.block_mix(
        torch.from_numpy(coeffs), [torch.from_numpy(x) for x in xs]
    )
    assert got.dtype == torch.from_numpy(xs[0]).dtype
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_mix_inplace_writes_xs0(dtype, rng):
    xs = [_state(rng, 4, dtype) for _ in range(3)]
    coeffs = rng.standard_normal((12, 4)).astype(dtype)
    want = np.asarray(
        jbd.block_mix(jnp.asarray(coeffs), [jnp.asarray(x) for x in xs], inplace=True)
    )
    txs = [torch.from_numpy(x.copy()) for x in xs]
    got = block_dense.block_mix(torch.from_numpy(coeffs), txs, inplace=True)
    assert got.data_ptr() == txs[0].data_ptr()
    _close(txs[0].numpy(), want, dtype)
    # the other operands are untouched
    assert np.array_equal(txs[1].numpy(), xs[1])


def test_block_mix_inplace_needs_matching_rows(rng):
    xs = [_state(rng, 4, np.float32), _state(rng, 2, np.float32)]
    coeffs = rng.standard_normal((6, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="p_out == xs"):
        jbd.block_mix(jnp.asarray(coeffs), [jnp.asarray(x) for x in xs], inplace=True)
    with pytest.raises(ValueError, match="p_out == xs"):
        block_dense.block_mix(
            torch.from_numpy(coeffs), [torch.from_numpy(x) for x in xs], inplace=True
        )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,include_zz", [((), True), ((4,), False), ((4,), True), ((3, 4, 2), True)])
def test_block_grams_matches_jax(rows, include_zz, dtype, rng):
    z = _state(rng, 4, dtype)
    xs = [_state(rng, r, dtype) for r in rows]
    want = np.asarray(
        jbd.block_grams([jnp.asarray(x) for x in xs], jnp.asarray(z), include_zz=include_zz)
    )
    got = block_dense.block_grams(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(z), include_zz=include_zz
    ).numpy()
    assert got.shape == want.shape == (sum(rows) + (4 if include_zz else 0), 4)
    _close(got, want, dtype)


@pytest.mark.parametrize("p", [2, 4])
def test_stencil_gram_matches_jax_and_aliases_dst(p, rng):
    jop = JaxOp.create(6, 6, 6, dtype=jnp.float32)
    top = PallasMaxwellOperator.create(6, 6, 6, device="cpu")
    q = _state(rng, p, np.float32)
    dst = _state(rng, p, np.float32)
    vj, g3j = jop.stencil_gram(jnp.asarray(q), jnp.asarray(dst))
    tq, tdst = torch.from_numpy(q.copy()), torch.from_numpy(dst.copy())
    v, g3 = top.stencil_gram(tq, tdst)
    assert v.data_ptr() == tdst.data_ptr()  # v IS dst's buffer
    assert torch.equal(tq, torch.from_numpy(q))  # q untouched
    np.testing.assert_allclose(
        v.numpy(), np.asarray(vj), rtol=0, atol=1e-6 * np.abs(np.asarray(vj)).max()
    )
    assert g3.shape == (3 * p, p)
    _close(g3.numpy(), np.asarray(g3j), np.float32)
    # the third block is gram(dst_OLD, q), taken before v overwrote dst
    gdq = dst.reshape(p, -1).astype(np.float64) @ q.reshape(p, -1).astype(np.float64).T
    _close(g3[2 * p :].numpy(), gdq, np.float32)


def test_stencil_gram_contract():
    assert stencil_gram.supports(4, torch.float32)
    assert stencil_gram.supports(stencil_gram.MAX_P, torch.float32)
    assert not stencil_gram.supports(stencil_gram.MAX_P + 1, torch.float32)
    assert not stencil_gram.supports(4, torch.float64)  # as JAX: f32 only
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    q = torch.zeros((2,) + top.state_shape)
    with pytest.raises(ValueError, match="different buffers"):
        top.stencil_gram(q, q)
    with pytest.raises(ValueError, match="q/dst"):
        top.stencil_gram(q, q[:1].clone())


def _wide_range(rng, p, n):
    """Values spread over e^+-6 (tests/test_block_dense.py:133-165): a plain
    f32 Gram of these loses ~10x more than eps_f32."""
    return (rng.standard_normal((p, n)) * np.exp(rng.uniform(-6, 6, (p, n)))
            ).astype(np.float32)


@pytest.mark.parametrize("include_zz", [False, True])
def test_block_grams_compensated_matches_jax_and_f64_oracle(include_zz, rng):
    """K7's plain version and JAX's K7 both reach 5e-7 of the f64 oracle's
    scale (~4 eps_f32, the JAX test's bound), where the plain f32 Gram
    misses it; each Gram block is held to its own scale."""
    p, n = 4, 1 << 16
    x, z = _wide_range(rng, p, n), _wide_range(rng, p, n)
    exact = [x.astype(np.float64) @ z.astype(np.float64).T]
    if include_zz:
        exact.append(z.astype(np.float64) @ z.astype(np.float64).T)
    want = np.asarray(jbd.block_grams_compensated(
        (jnp.asarray(x),), jnp.asarray(z), include_zz=include_zz))
    got = block_dense.block_grams_compensated(
        (torch.from_numpy(x),), torch.from_numpy(z), include_zz=include_zz)
    assert got.dtype == torch.float32 and got.shape == want.shape
    plain = block_dense.block_grams((torch.from_numpy(x),), torch.from_numpy(z))
    for i, ex in enumerate(exact):
        scale = np.abs(ex).max()
        rows = slice(i * p, (i + 1) * p)
        assert np.abs(got.numpy()[rows] - ex).max() / scale < 5e-7
        assert np.abs(want[rows] - ex).max() / scale < 5e-7
    assert np.abs(plain.numpy() - exact[0]).max() / np.abs(exact[0]).max() > 5e-7


def test_block_grams_compensated_takes_f32_only(rng):
    """f64 states raise: the JAX kernel would cast them to f32 and return
    an f32 Gram (ROADMAP Queue 3, reference-side faults)."""
    z = torch.from_numpy(_state(rng, 2, np.float64))
    with pytest.raises(ValueError, match="float32"):
        block_dense.block_grams_compensated((), z, include_zz=True)
    with pytest.raises(ValueError, match="row operands"):
        block_dense.block_grams_compensated((), z.float())


def test_compensated_block_lanczos_t_coefficients(rng):
    """tests/test_block_dense.py:168-189: the fused recurrence with every
    Gram compensated, from f32 storage, tracks the f64 recurrence's T
    coefficients: its first alpha block to f32 representation (5e-6), and
    overall no worse than 1.5x the plain f32 fused path (the bounds that
    test holds JAX's compensated run to)."""
    n, p, m = 2048, 4, 6
    a = rng.standard_normal((n, n))
    a = (a + a.T) / np.sqrt(n)
    b = rng.standard_normal((p, n))
    a64 = np.asarray(jax_block_lanczos(JaxMatrix(jnp.asarray(a)), jnp.asarray(b),
                                       m, fused=False).alphas)
    op32 = MatrixOperator(torch.from_numpy(a.astype(np.float32)))
    b32 = torch.from_numpy(b.astype(np.float32))
    comp = block_lanczos(op32, b32, m, compensated=True).alphas.numpy()
    plain = block_lanczos(op32, b32, m, fused=True).alphas.numpy()
    assert np.abs(comp[0] - a64[0]).max() < 5e-6 * np.abs(a64[0]).max()
    assert np.abs(comp - a64).max() <= 1.5 * np.abs(plain - a64).max()
