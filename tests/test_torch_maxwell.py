"""The port's Maxwell operators (lanczos_tpu_torch.models) against the JAX
package's, on the CPU: for the folded-plane operator, weights, layout,
packing, and A @ u (K1's plain version) against JAX's `apply_stencil_pair`
(Pallas in interpret mode) and against the scipy oracle in f64; for the
flat-state `MaxwellOperator` (`--operator stencil`), mv/mm against JAX's
and against the scipy oracle in f64 at N=3..10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.models.maxwell import MaxwellOperator as JaxMaxwell
from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu_torch.models.maxwell import MaxwellOperator, assemble_maxwell_A
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

# f32 tolerance of A @ u against JAX: the same taps in the same order and
# the same paired factoring, so only contraction of multiply-adds (FMA)
# may differ — a few ulps of the largest output
F32_STENCIL_RTOL = 1e-6


def _pair(n, jdt=jnp.float32, tdt=torch.float32):
    return JaxOp.create(n, n, n, dtype=jdt), PallasMaxwellOperator.create(
        n, n, n, dtype=tdt, device="cpu"
    )


@pytest.mark.parametrize("n", [3, 6, 10])
def test_weights_and_specs_bit_identical(n):
    jop, top = _pair(n)
    assert np.array_equal(np.asarray(jop.wz_t), top.wz_t.numpy())
    assert np.array_equal(np.asarray(jop.wplane_s), top.wplane_s.numpy())
    for js, ts in ((jop.spec_e, top.spec_e), (jop.spec_h, top.spec_h)):
        assert (ts.taps, ts.zc, ts.plane, ts.paired) == (
            js.taps, js.zc, js.plane, js.paired
        )
    assert top.state_shape == jop.state_shape
    assert top.n == jop.n


def test_layout_at_reference_size():
    """N=160: Zc = round_up(8 + 160 + 2, 16), P = round_up(163^2, 128)."""
    from lanczos_tpu_torch.models.maxwell_pallas import _host_taps

    (spec_e, _), wz_t, wplane_s = _host_taps(160, 160, 160, np.float32)
    assert (spec_e.zc, spec_e.plane) == (176, 26624)
    assert wz_t.shape == (2, 176, 12) and wplane_s.shape == (2, 12, 26624)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_arrays_takes_jax_weights(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jop = JaxOp.create(6, 6, 6, dtype=jdt)
    top = PallasMaxwellOperator.from_arrays(
        6, 6, 6, np.asarray(jop.wz_t), np.asarray(jop.wplane_s), dtype=dtype,
        device="cpu",
    )
    ref = PallasMaxwellOperator.create(6, 6, 6, dtype=dtype, device="cpu")
    assert torch.equal(top.wz_t, ref.wz_t)
    assert torch.equal(top.wplane_s, ref.wplane_s)
    with pytest.raises(ValueError, match="geometry"):
        PallasMaxwellOperator.from_arrays(
            6, 6, 14, np.asarray(jop.wz_t), np.asarray(jop.wplane_s),
            device="cpu",
        )


@pytest.mark.parametrize("n,p", [(3, 1), (6, 3), (10, 2)])
def test_pack_unpack_match_jax(n, p, rng):
    jop, top = _pair(n)
    b = rng.standard_normal((p, jop.n)).astype(np.float32)
    uj = np.asarray(jop.pack(jnp.asarray(b)))
    ut = top.pack(torch.from_numpy(b))
    assert np.array_equal(uj, ut.numpy())
    assert np.array_equal(np.asarray(jop.pack(jnp.asarray(b[0]))), top.pack(torch.from_numpy(b[0])).numpy())
    assert np.array_equal(top.unpack(ut).numpy(), b)
    assert np.array_equal(top.unpack(ut[0]).numpy(), b[0])


def test_state_index_and_trace_fn(rng):
    jop, top = _pair(6)
    for lc in (0, 20, 97, top.n // 2, top.n - 1):
        assert top.state_index(lc) == jop.state_index(lc)
    b = torch.from_numpy(rng.standard_normal((3, top.n)).astype(np.float32))
    u = top.pack(b)
    tr = top.trace_fn(20)(u)
    assert torch.equal(tr, b[:, 20])
    u.zero_()  # the trace is a copy: later in-place writes leave it alone
    assert torch.equal(tr, b[:, 20])
    with pytest.raises(IndexError):
        top.state_index(top.n)


@pytest.mark.parametrize("n", [3, 6, 10])
@pytest.mark.parametrize("p", [1, 3])
def test_stencil_plain_matches_jax(n, p, rng):
    jop, top = _pair(n)
    u = top.pack(torch.from_numpy(rng.standard_normal((p, top.n)).astype(np.float32)))
    vj = np.asarray(jop.mm(jnp.asarray(u.numpy())))
    vt = top.mm(u).numpy()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=F32_STENCIL_RTOL * np.abs(vj).max())
    # pad positions stay exactly zero
    assert np.array_equal(vt == 0, vj == 0)
    # single-state mv agrees with the block product
    np.testing.assert_array_equal(top.mv(u[0]).numpy(), vt[0])


@pytest.mark.parametrize("n", [3, 6])
def test_stencil_matches_scipy_f64(n, rng):
    """A = D diag(w) assembled by scipy is the f64 oracle: the stencil
    agrees to f64 rounding (1e-12 of the output scale)."""
    top = PallasMaxwellOperator.create(n, n, n, dtype=torch.float64, device="cpu")
    A = assemble_maxwell_A(n, n, n)
    x = rng.standard_normal((2, top.n))
    y = top.unpack(top.mm(top.pack(torch.from_numpy(x)))).numpy()
    ref = (A @ x.T).T
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_scaled_matches_jax_and_folds_into_z_weights(rng):
    jop, top = _pair(6)
    dt = np.float32(1.0 / 300)
    js, ts = jop.scaled(jnp.asarray(dt)), top.scaled(torch.tensor(dt))
    assert np.array_equal(np.asarray(js.wz_t), ts.wz_t.numpy())
    assert ts.wplane_s is top.wplane_s  # plane weights shared, not copied
    u = top.pack(torch.from_numpy(rng.standard_normal((2, top.n)).astype(np.float32)))
    np.testing.assert_allclose(
        ts.mm(u).numpy(), dt * top.mm(u).numpy(), rtol=1e-6,
        atol=1e-6 * dt * np.abs(top.mm(u).numpy()).max(),
    )


def test_unported_paths_raise():
    """What the operator refuses: bf16 states (not ported), and an FDTD
    step whose output buffer is its input (K5 writes a second buffer)."""
    top = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    u = torch.zeros((1,) + top.state_shape)
    with pytest.raises(ValueError, match="out must not be u"):
        top.fdtd_step(u, u)
    with pytest.raises(ValueError, match="float32 or float64"):
        PallasMaxwellOperator.create(3, 3, 3, dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fdtd_step_is_u_plus_a_u(dtype, rng):
    """K5's plain version: out = u + A u into a second buffer, u unchanged;
    (p, 6, Zc, P) and single (6, Zc, P) states."""
    top = PallasMaxwellOperator.create(6, 6, 6, dtype=dtype, device="cpu").scaled(0.01)
    u = top.pack(torch.from_numpy(rng.standard_normal((3, top.n))).to(dtype))
    keep = u.clone()
    out = torch.empty_like(u)
    got = top.fdtd_step(u, out)
    assert got.data_ptr() == out.data_ptr() and torch.equal(u, keep)
    torch.testing.assert_close(got, u + top.mm(u), rtol=0, atol=0)
    one = top.fdtd_step(u[1], torch.empty_like(u[1]))
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)


@pytest.mark.parametrize("n", [3, 6, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_maxwell_operator_matches_jax(n, dtype, rng):
    """The flat-state operator: the same taps multiplied in the same order
    as JAX's `_apply`, so f32 agrees to a few ulps of the output scale
    (1e-6), f64 to 1e-13; from_arrays carries JAX's weights over."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jop = JaxMaxwell.create(n, n, n, dtype=jdt)
    top = MaxwellOperator.create(n, n, n, dtype=dtype, device="cpu")
    assert top.n == jop.n and top.shape == jop.shape and top.dtype == dtype
    same = MaxwellOperator.from_arrays(
        n, n, n, [tuple(np.asarray(w) for w in t) for t in jop.tap_arrays],
        device="cpu")
    for mine, theirs in zip(same.tap_arrays, top.tap_arrays):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    x = rng.standard_normal((3, top.n))
    tol = (1e-6 if dtype == torch.float32 else 1e-13)
    # jitted, as the JAX methods call it (op-by-op it takes seconds)
    want = np.asarray(jax.jit(lambda o, v: o.mm(v))(jop, jnp.asarray(x, jdt)))
    got = top.mm(torch.from_numpy(x).to(dtype)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    want1 = np.asarray(jax.jit(lambda o, v: o.mv(v))(jop, jnp.asarray(x[0], jdt)))
    got1 = top.mv(torch.from_numpy(x[0]).to(dtype)).numpy()
    np.testing.assert_allclose(got1, want1, rtol=0, atol=tol * np.abs(want1).max())


@pytest.mark.parametrize("n", [3, 4, 7, 10])
def test_maxwell_operator_matches_scipy_f64(n, rng):
    """A = D diag(w) assembled by scipy, the f64 oracle (ROADMAP Queue 1
    item 2): mv agrees to 1e-12 of the output scale."""
    top = MaxwellOperator.create(n, n, n, dtype=torch.float64, device="cpu")
    A = assemble_maxwell_A(n, n, n)
    x = rng.standard_normal(top.n)
    ref = A @ x
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(), ref,
                               rtol=0, atol=1e-12 * np.abs(ref).max())


def test_maxwell_operator_from_arrays_checks_the_geometry():
    jop = JaxMaxwell.create(3, 3, 3)
    taps = [tuple(np.asarray(w) for w in t) for t in jop.tap_arrays]
    assert MaxwellOperator.from_arrays(3, 3, 3, taps, device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="geometry"):
        MaxwellOperator.from_arrays(4, 3, 3, taps, device="cpu")


def test_builders_default_to_cuda():
    """Every builder puts its buffers on the card unless asked for the
    CPU; without a card the default is an error, never a quiet CPU build."""
    from lanczos_tpu_torch.models.maxwell import maxwell_ell_operator

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    jop = JaxOp.create(3, 3, 3)
    taps = [tuple(np.asarray(w) for w in t) for t in JaxMaxwell.create(3, 3, 3).tap_arrays]
    for build in (
        lambda: PallasMaxwellOperator.create(3, 3, 3),
        lambda: PallasMaxwellOperator.from_arrays(
            3, 3, 3, np.asarray(jop.wz_t), np.asarray(jop.wplane_s)),
        lambda: MaxwellOperator.create(3, 3, 3),
        lambda: MaxwellOperator.from_arrays(3, 3, 3, taps),
        lambda: maxwell_ell_operator(3, 3, 3),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_maxwell_ell_operator_matches_jax_and_scipy(dtype, rng):
    """--operator ell's operator: width-4 ELL of the assembled A, the same
    matrix as JAX's (whose planes are f32 whatever the run's dtype),
    agreeing with scipy to f64 rounding; the fast block assembly gives JAX's
    lil-assembled matrix entry for entry."""
    from lanczos_tpu.models.maxwell import (
        assemble_maxwell_A as jax_assemble,
        maxwell_ell_operator as jax_ell,
    )
    from lanczos_tpu_torch.models.maxwell import maxwell_ell_operator

    a = assemble_maxwell_A(3, 4, 5)
    assert abs(a - jax_assemble(3, 4, 5)).max() == 0
    ell = maxwell_ell_operator(3, 4, 5, dtype=dtype, device="cpu")
    jell = jax_ell(3, 4, 5)
    assert ell.width == 4 and ell.shape == jell.shape and ell.dtype == dtype
    # JAX's native packer orders a row's slots its own way: compare the
    # matrices the planes hold
    np.testing.assert_array_equal(ell.to_dense().numpy().astype(np.float32),
                                  np.asarray(jell.to_dense()))
    x = rng.standard_normal((2, a.shape[1]))
    got = ell.mm(torch.from_numpy(x).to(dtype)).double().numpy()
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got, (a @ x.T).T, rtol=0,
                               atol=tol * np.abs(a @ x.T).max())


def test_interleave_perm_matches_jax_and_packs_tight():
    """maxwell_interleave_perm is JAX's ordering, and the windowed plan
    made with it has JAX's planes per chunk."""
    from lanczos_tpu.models.maxwell import maxwell_ell_operator as jax_ell
    from lanczos_tpu.models.maxwell import maxwell_interleave_perm as jax_perm
    from lanczos_tpu.ops.pallas.window_ell import windowed_from_ell as jax_from_ell
    from lanczos_tpu_torch.models.maxwell import (
        maxwell_ell_operator,
        maxwell_interleave_perm,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_ell

    perm = maxwell_interleave_perm(6, 6, 6)
    np.testing.assert_array_equal(perm, jax_perm(6, 6, 6))
    ell = maxwell_ell_operator(6, 6, 6, dtype=torch.float64, device="cpu")
    W = windowed_from_ell(ell, perm=perm)
    assert W.ppc == jax_from_ell(jax_ell(6, 6, 6), perm=perm).ppc
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, ell.shape[0])))
    torch.testing.assert_close(W.unpermute(W.mm(W.permute(x))), ell.mm(x),
                               rtol=0, atol=1e-12)
