"""bf16 folded-plane states: the port's bf16 `PallasMaxwellOperator` (f32
weights, f32 sums, bf16 storage) against the JAX package's
`PallasMaxwellOperator.create(dtype=bfloat16)` on the CPU, Pallas in
interpret mode.  K1 (`apply_stencil_pair`) and K2/K3/K7 (`block_mix`,
`block_grams`, `block_grams_compensated`) through their plain versions,
the FDTD oracle (K1 then an add, never K5), vector and block Lanczos
(classic and fused: K1, K2, K3, never K4), and what both packages refuse.

Inputs are drawn with numpy, rounded to bf16 once in torch (round to
nearest even, as JAX's astype) and handed to JAX as the same bf16 values,
so both sides start from identical states.  Each tolerance is stated
where it is used.  The bf16 kernels are held to their plain versions on
the card by tests/test_torch_kernels.py (`-m cuda`; this file imports jax,
which the card's machine lacks) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.methods.block_lanczos import block_lanczos as jax_block_lanczos
from lanczos_tpu.methods.expm_action import (
    block_lanczos_expm_action as jax_block_expm,
    lanczos_expm_action as jax_expm,
)
from lanczos_tpu.methods.fdtd import fdtd_block as jax_fdtd_block
from lanczos_tpu.methods.fdtd import fdtd_vector as jax_fdtd_vector
from lanczos_tpu.methods.vector_lanczos import vector_lanczos as jax_vector_lanczos
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu.ops.pallas import block_dense as jbd
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.expm_action import (
    block_lanczos_expm_action,
    lanczos_expm_action,
)
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.models.maxwell import MaxwellOperator
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.kernels import block_dense, build, stencil_gram
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    STENCIL_ROW_WEIGHTS,
    STENCIL_SLOTS,
    apply_stencil,
    apply_stencil_pair,
    apply_stencil_pair_plain,
    gram_plan,
    pair_plan,
    stencil_plan,
)
from lanczos_tpu_torch.parallel.dist_stencil import DistributedPallasMaxwell
from lanczos_tpu_torch.parallel.mesh import Mesh

BF16 = torch.bfloat16
# one bf16 ulp: 8 significant bits, so a value x sits within 2^-7 |x| of
# its neighbours; the f32 sums of the two packages may round to either
ULP = 2.0**-7


def _ops(n):
    return (JaxOp.create(n, n, n, dtype=jnp.bfloat16),
            PallasMaxwellOperator.create(n, n, n, dtype=BF16, device="cpu"))


def _bf16_state(rng, top, p=None):
    """A packed bf16 state (p, 6, Zc, P) (or (6, Zc, P)) in torch and the
    same bf16 values as a JAX array."""
    x = rng.standard_normal((top.n,) if p is None else (p, top.n))
    u = top.pack(torch.from_numpy(x))
    return u, jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)


def _f32(x):
    """A torch or JAX array as f32 NumPy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulp(got, want):
    """|got - want| <= one bf16 ulp of want per element; elements under
    1e-6 of the largest |want| are held to 1e-6 of it."""
    got, want = _f32(got), _f32(want)
    floor = 1e-6 * np.abs(want).max()
    bound = np.maximum(ULP * np.abs(want), floor)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def _close_to_max(got, want, frac):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


@pytest.mark.parametrize("n", [3, 5])
def test_create_keeps_f32_weights_and_bf16_state(n):
    """The operator's weights are JAX's bf16 operator's f32 ones, bit for
    bit; `dtype` is the states' bf16, and `pack` packs into it."""
    jop, top = _ops(n)
    assert top.dtype == BF16 and jop.dtype == jnp.bfloat16
    assert top.wz_t.dtype == top.wplane_s.dtype == torch.float32
    assert np.array_equal(np.asarray(jop.wz_t), top.wz_t.numpy())
    assert np.array_equal(np.asarray(jop.wplane_s), top.wplane_s.numpy())
    x = np.random.default_rng(n).standard_normal(top.n)
    u = top.pack(torch.from_numpy(x))
    assert u.dtype == BF16 and u.shape == top.state_shape
    assert np.array_equal(_f32(u), _f32(jop.pack(jnp.asarray(x))))
    assert np.array_equal(_f32(top.unpack(u)), _f32(jop.unpack(jop.pack(jnp.asarray(x)))))


def test_from_arrays_takes_a_jax_bf16_operators_weights():
    jop = JaxOp.create(4, 4, 4, dtype=jnp.bfloat16)
    top = PallasMaxwellOperator.from_arrays(
        4, 4, 4, np.asarray(jop.wz_t), np.asarray(jop.wplane_s), dtype=BF16,
        device="cpu")
    assert top.dtype == BF16 and top.wz_t.dtype == torch.float32
    assert np.array_equal(np.asarray(jop.wz_t), top.wz_t.numpy())


@pytest.mark.parametrize("n,p", [(3, 1), (3, 3), (6, 1), (7, 3)])
def test_k1_plain_matches_jax_within_one_ulp(n, p, rng):
    """K1 on a bf16 state: both promote to the f32 weights, sum the same
    taps in the same factored form in f32 and round once; FMA contraction
    may move the f32 sum by an ulp of f32, so the bf16 results agree to
    one bf16 ulp."""
    jop, top = _ops(n)
    u, ju = _bf16_state(rng, top, p)
    got = top.mm(u)
    assert got.dtype == BF16
    _within_ulp(got, jop.mm(ju))
    _within_ulp(apply_stencil_pair_plain(u, top.wz_t, top.wplane_s, top.spec_e,
                                         top.spec_h), jop.mm(ju))


def test_bf16_operator_against_the_f32_operator(rng):
    """JAX's own bound for its bf16 operator (tests/test_maxwell_pallas.py
    test_bf16_state_mv): the input's bf16 rounding, ~1e-2 of scale."""
    ref = MaxwellOperator.create(5, 6, 7, dtype=torch.float32, device="cpu")
    op = PallasMaxwellOperator.create(5, 6, 7, dtype=BF16, device="cpu")
    x = torch.from_numpy(rng.standard_normal(ref.n).astype(np.float32))
    y = op.unpack(op.mv(op.pack(x))).float()
    y_ref = ref.mv(x)
    assert ((y - y_ref).abs().max() / y_ref.abs().max()).item() < 5e-2


def _mix_states(rng, k):
    """k bf16 states (2, 6, Zc, P) at N=3: Zc = 16, P = 128, so JAX's
    `_plan_blocks` tiles them ((16, 128) blocks) and takes its Pallas
    kernel branch, not the `plan is None` einsum fallback (which rounds
    the coefficients to bf16)."""
    top = PallasMaxwellOperator.create(3, 3, 3, dtype=BF16, device="cpu")
    assert top.state_shape[1] % 16 == 0 and top.state_shape[2] % 128 == 0
    return [_bf16_state(rng, top, 2) for _ in range(k)]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_k2_plain_matches_jax_within_one_ulp(k, rng):
    """block_mix on bf16 states with f32 coefficients: f32 sums, one
    rounding to bf16, as JAX's kernel branch."""
    states = _mix_states(rng, k)
    coeffs = rng.standard_normal((2 * k, 2)).astype(np.float32)
    want = jbd.block_mix(jnp.asarray(coeffs), [j for _, j in states])
    got = block_dense.block_mix(torch.from_numpy(coeffs), [u for u, _ in states])
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(got, want)


def _gram_bound(xs, z):
    """1e-6 of sum |x||z|: the products of bf16 values are exact in f32,
    so the two Grams differ only by the f32 sums' order."""
    a = np.concatenate([np.abs(_f32(x)).reshape(x.shape[0], -1) for x in xs])
    return 1e-6 * (a @ np.abs(_f32(z)).reshape(z.shape[0], -1).T)


@pytest.mark.parametrize("include_zz", [False, True])
def test_k3_plain_matches_jax_with_an_f32_gram(include_zz, rng):
    (x, jx), (y, jy), (z, jz) = _mix_states(rng, 3)
    want = np.asarray(jbd.block_grams((jx, jy), jz, include_zz=include_zz))
    got = block_dense.block_grams((x, y), z, include_zz=include_zz)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    ops = (x, y, z) if include_zz else (x, y)
    assert np.all(np.abs(got.numpy() - want) <= _gram_bound(ops, z))


def test_k7_plain_matches_jax_on_bf16_states(rng):
    """K7 widens bf16 to f32 and returns an f32 Gram, as JAX's; on flat
    states (JAX's interpret-mode K7 takes minutes on a folded-plane one)."""
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32)).to(BF16)
    z = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32)).to(BF16)
    jx, jz = (jnp.asarray(_f32(t)).astype(jnp.bfloat16) for t in (x, z))
    want = np.asarray(jbd.block_grams_compensated((jx,), jz, include_zz=True))
    got = block_dense.block_grams_compensated((x,), z, include_zz=True)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.all(np.abs(got.numpy() - want) <= _gram_bound((x, z), z))


@pytest.mark.parametrize("block", [False, True])
def test_fdtd_matches_jax_through_k1_and_an_add(block, rng, monkeypatch):
    """10 forward-Euler steps: dt made in bf16 and folded into the f32
    weights, then u + (dt A) u, K1 then a bf16 add; the one-pass step (K5)
    is never called.  2e-2 of scale: ten bf16 roundings of the state."""
    def no_k5(*args, **kw):
        raise AssertionError("a bf16 FDTD step called fdtd_step (K5)")

    monkeypatch.setattr(PallasMaxwellOperator, "fdtd_step", no_k5)
    jop, top = _ops(4)
    u, ju = _bf16_state(rng, top, 3 if block else None)
    if block:
        got, want = fdtd_block(top, u, 10, 0.1), jax_fdtd_block(jop, ju, 10, 0.1)
    else:
        got, want = fdtd_vector(top, u, 10, 0.1), jax_fdtd_vector(jop, ju, 10, 0.1)
    assert got.dtype == BF16
    _close_to_max(got, want, 2e-2)


def _close_lanczos(r, j):
    """Two bf16 Lanczos runs, the port's and JAX's.  Their reductions sum
    in other orders, so now and then one rounds to the neighbouring bf16
    (2^-8 of scale), and the runs drift apart by a few bf16 ulps of scale
    over m steps.  The alphas of the Maxwell operator are rounding noise
    around 0 (its alphas vanish in exact arithmetic), so alphas and betas
    are held to rtol 2e-2 and 1e-2 of T's scale, the largest |entry| of T
    (alphas and betas[1:]; betas[0] is ||b||); the trace to rtol 2e-2 and
    2e-2 of its largest |value|: an element that is small may differ by
    20% of itself (the f32 and bf16 runs' trace element 3 does)."""
    alphas, betas = _f32(j.alphas), _f32(j.betas)
    t_scale = np.abs(np.concatenate([alphas.ravel(), betas[1:].ravel()])).max()
    np.testing.assert_allclose(_f32(r.alphas), alphas, rtol=2e-2, atol=1e-2 * t_scale)
    np.testing.assert_allclose(_f32(r.betas), betas, rtol=2e-2, atol=1e-2 * t_scale)
    trace = _f32(j.trace)
    np.testing.assert_allclose(_f32(r.trace), trace, rtol=2e-2,
                               atol=2e-2 * np.abs(trace).max())


@pytest.mark.parametrize("fused", [False, True])
def test_vector_lanczos_matches_jax(fused, rng):
    """Classic, and fused at block width 1 (K2 -> K1 -> K3 with f32 small
    algebra, tiny and eps of bf16), on a bf16 state: bf16 alphas, betas
    and trace, at `_close_lanczos`'s tolerances."""
    jop, top = _ops(3)
    u, ju = _bf16_state(rng, top)
    lc = 7
    r = vector_lanczos(top, u, 6, trace_fn=top.trace_fn(lc), fused=fused)
    j = jax_vector_lanczos(jop, ju, 6, trace_fn=jop.trace_fn(lc), fused=fused)
    assert r.alphas.dtype == BF16
    _close_lanczos(r, j)


@pytest.mark.parametrize("fused", [False, True])
def test_block_lanczos_at_p3_matches_jax(fused, rng):
    """JAX runs block Lanczos at p >= 2 on a bf16 state with its default
    Jacobi sqrtm (the fused route's 3-call step: K4 refuses bf16), and so
    does the port; at `_close_lanczos`'s tolerances (betas[0] is then
    sqrtm(B^T B), a p x p block)."""
    jop, top = _ops(3)
    u, ju = _bf16_state(rng, top, 3)

    def trace(q):
        return q[:, 0, 9, 20]

    r = block_lanczos(top, u, 4, trace_fn=trace, fused=fused)
    j = jax_block_lanczos(jop, ju, 4, trace_fn=trace, fused=fused)
    assert r.alphas.dtype == BF16
    _close_lanczos(r, j)


def test_the_expm_actions_and_eigsh_refuse_bf16_in_both_packages(rng):
    """expm(T) and eigsh need eigh, which takes no bf16 T: JAX raises
    NotImplementedError after its Lanczos run, the port ValueError before."""
    jop, top = _ops(3)
    u, ju = _bf16_state(rng, top, 4)
    with pytest.raises(NotImplementedError):
        jax_block_expm(jop, ju, 3, 0.1, 0, trace_fn=lambda q: q[:, 0, 9, 20])
    with pytest.raises(ValueError, match="bfloat16"):
        block_lanczos_expm_action(top, u, 3, 0.1, 0, trace_fn=lambda q: q[:, 0, 9, 20])
    with pytest.raises(NotImplementedError):
        jax_expm(jop, ju[0], 3, 0.1, 0, trace_fn=jop.trace_fn(7))
    with pytest.raises(ValueError, match="bfloat16"):
        lanczos_expm_action(top, u[0], 3, 0.1, 0, trace_fn=top.trace_fn(7))
    with pytest.raises(ValueError, match="bfloat16"):
        block_lanczos(top, u, 3, eig_backend="lax", fused=False)
    from lanczos_tpu.methods.eigs import lanczos_eigsh as jax_eigsh
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, lanczos_eigsh

    with pytest.raises(NotImplementedError):
        jax_eigsh(jop, ju[0], 3, k=1, trace_fn=jop.trace_fn(7))
    with pytest.raises(ValueError, match="bfloat16"):
        lanczos_eigsh(top, u[0], 3, k=1)
    with pytest.raises(ValueError, match="bfloat16"):
        block_lanczos_eigsh(top, u, 3, k=1)


def test_k4_k5_and_k6_refuse_bf16(rng):
    """Neither the fused pass (K4) nor the one-pass FDTD step (K5) takes a
    bf16 state (JAX's plans refuse every type but f32), nor does K6 (its
    TPU kernel rolls bf16 lanes with no upcast), on every device."""
    jop, top = _ops(3)
    assert not top.supports_stencil_gram(1) and not jop.supports_stencil_gram(1)
    assert not top.supports_fdtd_inplace(4) and not jop.supports_fdtd_inplace(4)
    assert top.supports_fdtd_inplace(4, torch.float32)
    u, _ = _bf16_state(rng, top, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        top.fdtd_step(u, torch.empty_like(u))
    with pytest.raises(ValueError, match="bfloat16"):
        top.stencil_gram(u, u.clone())
    with pytest.raises(ValueError, match="bfloat16"):
        apply_stencil(u[:, :3], top.wz_t[0].T, top.wplane_s[0], top.spec_e)
    loose = [type(top.spec_e)(**{**vars(s), "paired": False})
             for s in (top.spec_e, top.spec_h)]
    with pytest.raises(ValueError, match="bfloat16"):
        apply_stencil_pair(u, top.wz_t, top.wplane_s, *loose)


def test_scaled_keeps_a_bf16_state_with_f32_weights(rng):
    """scaled(dt) folds dt into the f32 z-weights (after dt's rounding to
    the state's bf16 in the FDTD loop, as JAX) and keeps the state bf16."""
    jop, top = _ops(3)
    dt = torch.tensor(1.0 / 300, dtype=BF16)
    s = top.scaled(dt)
    assert s.dtype == BF16 and s.wz_t.dtype == torch.float32
    assert s.wplane_s is top.wplane_s
    js = jop.scaled(jnp.asarray(1.0 / 300, jnp.bfloat16))
    assert np.array_equal(np.asarray(js.wz_t), s.wz_t.numpy())


def test_checkpointed_runs_refuse_bf16(rng, tmp_path):
    """The JAX package writes a bf16 run's checkpoint as raw 2-byte
    records that its own resume cannot read (a TypeError on the second
    call); the port's checkpointed drivers refuse bf16 before any work."""
    from lanczos_tpu.methods.checkpoint import (
        vector_lanczos_checkpointed as jax_checkpointed,
    )
    from lanczos_tpu_torch.methods.checkpoint import (
        block_lanczos_checkpointed,
        fdtd_checkpointed,
        vector_lanczos_checkpointed,
    )

    jop, top = _ops(3)
    u, ju = _bf16_state(rng, top)
    path = str(tmp_path / "jax.npz")
    jax_checkpointed(jop, ju, 4, chunk=2, path=path, trace_fn=jop.trace_fn(7))
    with pytest.raises(TypeError):
        jax_checkpointed(jop, ju, 4, chunk=2, path=path, trace_fn=jop.trace_fn(7))
    port = str(tmp_path / "port.npz")
    with pytest.raises(ValueError, match="bfloat16"):
        vector_lanczos_checkpointed(top, u, 4, chunk=2, path=port,
                                    trace_fn=top.trace_fn(7))
    with pytest.raises(ValueError, match="bfloat16"):
        block_lanczos_checkpointed(top, u[None], 4, chunk=2, path=port)
    with pytest.raises(ValueError, match="bfloat16"):
        fdtd_checkpointed(top, u, 10, 0.1, chunk=5, path=port)
    assert not (tmp_path / "port.npz").exists()


def test_the_z_slab_operator_refuses_bf16():
    """JAX's z-slab operator builds bf16 weights, which its own K1 refuses
    at its default tz=8; the port's refuses bf16 before any collective (a
    Mesh with no process group)."""
    mesh = Mesh(0, 2, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="bfloat16"):
        DistributedPallasMaxwell.create(4, 4, 4, mesh, dtype=BF16)


def test_dtype_codes_and_the_bf16_launch_counts():
    """dtype code 2 is a bf16 state, taken only where the kernel has one;
    bf16 launches count apart, and the CPU launches nothing."""
    u = torch.zeros(4, dtype=BF16)
    assert build.dtype_code(u, True) == 2
    with pytest.raises(TypeError, match="bfloat16"):
        build.dtype_code(u)
    with pytest.raises(TypeError, match="float32, float64"):
        build.dtype_code(torch.zeros(4, dtype=torch.float16), True)
    assert {k for k in build.LAUNCHES if k.endswith(" bf16")} == {
        "apply_stencil_pair bf16", "block_mix bf16", "block_grams bf16",
        "block_grams_compensated bf16"}
    assert build.acc_dtype(BF16) == torch.float32


def test_k1_bf16_strip_plan_at_n160():
    """K1's plan for a bf16 state: the f32 strip (512 lanes, two a
    thread), halos in whole 16-byte copies of 8 bf16, a ring of bf16 rows
    and two rows' z-weights in f32; K4 takes no bf16."""
    top = PallasMaxwellOperator.create(160, 160, 160, dtype=BF16, device="meta")
    plan = pair_plan(top.spec_e, top.spec_h, 8, 2, 132)
    assert (plan.width, plan.lanes_per_thread) == (512, 2)
    assert all(h % 8 == 0 for h in plan.left + plan.right)
    assert plan.smem_bytes == STENCIL_SLOTS * plan.row * 2 + 2 * STENCIL_ROW_WEIGHTS * 4
    f32 = stencil_plan(top.spec.zc, top.spec.plane, plan.left, plan.right, 8, 4, 132)
    assert plan.row <= f32.row + 6 * 8 and plan.smem_bytes < f32.smem_bytes
    assert block_dense.gram_vector_width(top.spec.zc * top.spec.plane * 6, 2,
                                         [0, 16]) == 8
    with pytest.raises(ValueError, match="4- or 8-byte"):
        gram_plan(top.spec.zc, top.spec.plane, plan.left, plan.right, 1, 2, 132)
    assert not stencil_gram.supports(1, BF16)
