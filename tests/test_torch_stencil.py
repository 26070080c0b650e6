"""K6, the port's generic separable stencil (`apply_stencil`, its plain
version on the CPU), against the JAX package's `apply_stencil` (Pallas in
interpret mode) on numpy-seeded inputs, and the unpaired curl pair: K1,
and K4 and K5 with paired=False on either half, against JAX's
`apply_stencil_pair`, `apply_stencil_pair_gram` and `fdtd_step_inplace`.

The Pallas kernel reads a clamped neighbour block where a z-shift leaves
the state; the port reads 0.  The two agree wherever a dz=-1 tap's z-weight
is zero on row 0 and a dz=+1 tap's on row Zc-1, the invariant every operator
constructor keeps, so the fixtures here keep it too.  Tolerances, relative to the
output's largest |value|: the same taps multiplied in the same order, so
f32 differs by contraction of multiply-adds only (1e-6), f64 by 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.models.maxwell_pallas import PallasMaxwellOperator as JaxOp
from lanczos_tpu.ops.pallas import StencilSpec as JaxSpec
from lanczos_tpu.ops.pallas import apply_stencil as jax_apply_stencil
from lanczos_tpu.ops.pallas import apply_stencil_pair as jax_apply_stencil_pair
from lanczos_tpu.ops.pallas.stencil_fdtd import fdtd_step_inplace as jax_fdtd_step
from lanczos_tpu.ops.pallas.stencil_gram import (
    apply_stencil_pair_gram as jax_stencil_gram,
)
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.kernels import build, stencil_fdtd, stencil_gram
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    MAX_COMPS,
    MAX_GENERIC_TAPS,
    StencilSpec,
    apply_stencil,
    apply_stencil_pair,
    generic_tap_table,
    stencil_into,
)

RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _all_taps(n_in, plane, xc):
    """All 27 (dz, roll) combinations of a 3x3x3 neighbourhood, over the
    input components in turn."""
    taps = []
    for k, (dz, dy, dx) in enumerate(
        (dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ):
        taps.append((k % n_in, dz, (-(dy * xc) - dx) % plane))
    return taps


def _spec(kind, zc=16, plane=256):
    """Tap sets: 6 -> 3 with 27 taps per output component; a 7-point
    Laplacian 1 -> 1; 2 -> 4 with 1..5 random taps per component, in a
    shuffled spec order."""
    xc = 13
    if kind == "27-point 6->3":
        taps = [(oc, ic, dz, r) for oc in range(3)
                for ic, dz, r in _all_taps(6, plane, xc)]
        taps = [(oc, (ic + oc) % 6, dz, r) for oc, ic, dz, r in taps]
        return StencilSpec(6, 3, tuple(taps), zc, plane)
    if kind == "laplacian 1->1":
        offs = [(0, 0), (-1, 0), (1, 0), (0, 1), (0, plane - 1), (0, xc),
                (0, plane - xc)]
        return StencilSpec(1, 1, tuple((0, 0, dz, r) for dz, r in offs), zc, plane)
    rng = np.random.default_rng(7)
    taps = []
    for oc in range(4):
        for _ in range(1 + oc):
            taps.append((oc, int(rng.integers(2)), int(rng.integers(-1, 2)),
                         int(rng.integers(plane))))
    order = rng.permutation(len(taps))
    return StencilSpec(2, 4, tuple(taps[i] for i in order), zc, plane)


def _weights(spec, rng, dtype):
    """wz (n_taps, Zc), zero on row 0 for dz=-1 taps and on row Zc-1 for
    dz=+1 taps; wplane (n_taps, P)."""
    nt = len(spec.taps)
    wz = rng.standard_normal((nt, spec.zc))
    for t, (_, _, dz, _) in enumerate(spec.taps):
        if dz == -1:
            wz[t, 0] = 0.0
        if dz == 1:
            wz[t, -1] = 0.0
    wp = rng.standard_normal((nt, spec.plane))
    return (torch.from_numpy(wz).to(dtype), torch.from_numpy(wp).to(dtype))


def _jax_spec(spec):
    return JaxSpec(spec.n_in, spec.n_out, spec.taps, spec.zc, spec.plane,
                   paired=spec.paired)


def _close(got, want, dtype):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["27-point 6->3", "laplacian 1->1", "random 2->4"])
def test_apply_stencil_matches_jax(kind, dtype, rng):
    spec = _spec(kind)
    wz, wp = _weights(spec, rng, dtype)
    u = torch.from_numpy(rng.standard_normal((spec.n_in, spec.zc, spec.plane))).to(dtype)
    build.reset_launches()
    got = apply_stencil(u, wz, wp, spec)
    assert build.LAUNCHES["apply_stencil"] == 0  # the CPU runs the plain version
    assert got.shape == (spec.n_out, spec.zc, spec.plane) and got.dtype == dtype
    want = jax_apply_stencil(jnp.asarray(u.numpy()), jnp.asarray(wz.numpy()),
                             jnp.asarray(wp.numpy()), _jax_spec(spec),
                             interpret=True)
    assert want.dtype == JNP[dtype]
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("half", [0, 1])
def test_maxwell_half_unpaired_matches_jax(half, dtype, rng):
    """The Maxwell E-half (h=0, reads H) and H-half (h=1, reads E) specs
    with paired=False through K6, against JAX's apply_stencil on the same
    slice: the unfactored form of one curl half."""
    n = 4
    top = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device="cpu")
    spec = dataclasses.replace((top.spec_e, top.spec_h)[half], paired=False)
    u = top.pack(torch.from_numpy(rng.standard_normal((1, top.n))).to(dtype))[0]
    base = 3 * (1 - half)
    wz, wp = top.wz_t[half].T, top.wplane_s[half]
    got = apply_stencil(u[base : base + 3], wz, wp, spec)
    want = jax_apply_stencil(jnp.asarray(u[base : base + 3].numpy()),
                             jnp.asarray(wz.numpy()), jnp.asarray(wp.numpy()),
                             _jax_spec(spec), interpret=True)
    _close(got.numpy(), want, dtype)
    # the unfactored half equals the paired (factored) product to rounding
    _close(got.numpy(), top.mm(u[None])[0, 3 * half : 3 * half + 3].numpy(), dtype)


def test_leading_block_axis_equals_a_loop(rng):
    """(p, n_in, Zc, P) is what jax.vmap(apply_stencil) takes: each block
    column as its own call."""
    spec = _spec("random 2->4", zc=24, plane=128)
    wz, wp = _weights(spec, rng, torch.float64)
    u = torch.from_numpy(rng.standard_normal((3, spec.n_in, spec.zc, spec.plane)))
    got = apply_stencil(u, wz, wp, spec)
    assert got.shape == (3, spec.n_out, spec.zc, spec.plane)
    for b in range(3):
        torch.testing.assert_close(got[b], apply_stencil(u[b], wz, wp, spec),
                                   rtol=0, atol=0)


def test_stencil_into_component_slices(rng):
    """K6 on component slices of larger states, with a strided wz (the
    transpose of a (Zc, n_taps) array), writes only its output slice."""
    spec = _spec("laplacian 1->1", zc=16, plane=128)
    wz, wp = _weights(spec, rng, torch.float64)
    big = torch.from_numpy(rng.standard_normal((2, 3, spec.zc, spec.plane)))
    out = torch.zeros_like(big)
    stencil_into(big[:, 2:3], out[:, 0:1], wz.T.contiguous().T, wp, spec)
    torch.testing.assert_close(out[:, 0:1], apply_stencil(big[:, 2:3], wz, wp, spec),
                               rtol=0, atol=0)
    assert torch.count_nonzero(out[:, 1:]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("unpaired", ["both", "e", "h"])
def test_unpaired_pair_matches_jax(unpaired, dtype, rng):
    """apply_stencil_pair with paired=False on either half equals JAX's
    apply_stencil_pair with the same specs (its unpaired branch, interpret
    mode); a paired half keeps the factored form on both sides."""
    n = 4
    jop = JaxOp.create(n, n, n, dtype=JNP[dtype])
    top = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device="cpu")
    loose = {k: dataclasses.replace(s, paired=unpaired not in ("both", k))
             for k, s in (("e", top.spec_e), ("h", top.spec_h))}
    u = top.pack(torch.from_numpy(rng.standard_normal((2, top.n))).to(dtype))
    got = apply_stencil_pair(u, top.wz_t, top.wplane_s, loose["e"], loose["h"])
    jspecs = [dataclasses.replace(s, paired=loose[k].paired)
              for k, s in (("e", jop.spec_e), ("h", jop.spec_h))]
    for b in range(2):
        want = jax_apply_stencil_pair(jnp.asarray(u[b].numpy()), jop.wz_t,
                                      jop.wplane_s, *jspecs, interpret=True)
        _close(got[b].numpy(), want, dtype)
    _close(got.numpy(), top.mm(u).numpy(), dtype)


def _loose_pair(unpaired, n, dtype):
    """The JAX and port operators of an n^3 grid and both packages' specs
    with paired=False on the E half, the H half or both."""
    jop = JaxOp.create(n, n, n, dtype=JNP[dtype])
    top = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device="cpu")
    specs = [dataclasses.replace(s, paired=unpaired not in ("both", k))
             for k, s in (("e", top.spec_e), ("h", top.spec_h))]
    jspecs = [dataclasses.replace(s, paired=t.paired)
              for s, t in zip((jop.spec_e, jop.spec_h), specs)]
    return jop, top, specs, jspecs


@pytest.mark.parametrize("unpaired", ["both", "e", "h"])
def test_unpaired_fdtd_step_matches_jax(unpaired, rng):
    """K5's unpaired branch: out = u + (dt A) u with an unpaired half
    summed tap by tap, against JAX's fdtd_step_inplace (interpret mode),
    f32.  JAX starts each component's sum at u and the port adds u last:
    rounding of the same terms, so 1e-6 of the result's scale."""
    jop, top, specs, jspecs = _loose_pair(unpaired, 4, torch.float32)
    dt = np.float32(0.01)
    js, ts = jop.scaled(jnp.asarray(dt)), top.scaled(torch.tensor(dt))
    u = top.pack(torch.from_numpy(rng.standard_normal((2, top.n)).astype(np.float32)))
    got = stencil_fdtd.fdtd_step(u, torch.empty_like(u), ts.wz_t, ts.wplane_s, *specs)
    want = jax_fdtd_step(jnp.asarray(u.numpy()), js.wz_t, js.wplane_s, *jspecs,
                         interpret=True)
    _close(got.numpy(), want, torch.float32)
    # the unfactored half moves the result by rounding only
    _close(got.numpy(), ts.fdtd_step(u, torch.empty_like(u)).numpy(), torch.float32)


@pytest.mark.parametrize("unpaired", ["both", "e", "h"])
def test_unpaired_stencil_gram_matches_jax(unpaired, rng):
    """K4's unpaired branch: v = A q into dst and [gram(q,v); gram(v,v);
    gram(dst,q)], against JAX's apply_stencil_pair_gram (interpret mode),
    f32; the Grams to 2e-6 of their scale (sums in another order)."""
    jop, top, specs, jspecs = _loose_pair(unpaired, 4, torch.float32)
    q, dst = (top.pack(torch.from_numpy(rng.standard_normal((2, top.n)).astype(np.float32)))
              for _ in range(2))
    keep = dst.clone()
    v, g3 = stencil_gram.apply_stencil_pair_gram(q, dst, top.wz_t, top.wplane_s, *specs)
    assert v.data_ptr() == dst.data_ptr()
    vj, g3j = jax_stencil_gram(jnp.asarray(q.numpy()), jnp.asarray(keep.numpy()),
                               jop.wz_t, jop.wplane_s, *jspecs, interpret=True)
    _close(v.numpy(), vj, torch.float32)
    g3j = np.asarray(g3j, np.float64)
    np.testing.assert_allclose(g3.numpy(), g3j, rtol=0, atol=2e-6 * np.abs(g3j).max())


def test_generic_tap_table_layout():
    spec = _spec("random 2->4", zc=16, plane=128)
    tab = list(generic_tap_table(spec))
    stride = 1 + 4 * MAX_GENERIC_TAPS
    assert len(tab) == 1 + MAX_COMPS * stride and tab[0] == spec.n_out
    for oc in range(MAX_COMPS):
        rec = tab[1 + oc * stride : 1 + (oc + 1) * stride]
        idx = [t for t, tp in enumerate(spec.taps) if tp[0] == oc]
        n = rec[0]
        assert n == len(idx)
        t, ic, dz, r = (rec[1 + k * MAX_GENERIC_TAPS : 1 + k * MAX_GENERIC_TAPS + n]
                        for k in range(4))
        assert t == idx  # spec order
        assert ic == [spec.taps[i][1] for i in idx]
        assert dz == [spec.taps[i][2] for i in idx]
        assert r == [spec.taps[i][3] % spec.plane for i in idx]


def test_what_k6_refuses(rng):
    spec = _spec("laplacian 1->1", zc=16, plane=128)
    wz, wp = _weights(spec, rng, torch.float32)
    u = torch.zeros((1, spec.zc, spec.plane))
    with pytest.raises(ValueError, match="float32 or float64"):
        apply_stencil(u.bfloat16(), wz.bfloat16(), wp.bfloat16(), spec)
    no_taps = dataclasses.replace(spec, n_out=2)
    with pytest.raises(ValueError, match="component 1 has 0 taps"):
        apply_stencil(u, wz, wp, no_taps)
    many = StencilSpec(1, 1, ((0, 0, 0, 0),) * (MAX_GENERIC_TAPS + 1), 16, 128)
    with pytest.raises(ValueError, match="28 taps"):
        apply_stencil(u, torch.zeros((28, 16)), torch.zeros((28, 128)), many)
    wide = StencilSpec(MAX_COMPS + 1, 1, ((0, 0, 0, 0),), 16, 128)
    with pytest.raises(ValueError, match="components in and out"):
        apply_stencil(torch.zeros((7, 16, 128)), wz[:1], wp[:1], wide)
    with pytest.raises(ValueError, match="out of range"):
        apply_stencil(u, wz[:1], wp[:1], StencilSpec(1, 1, ((0, 1, 0, 0),), 16, 128))
    with pytest.raises(ValueError, match="weights"):
        apply_stencil(u, wz[:, :8], wp, spec)
    meta = torch.empty((1, 1, 16, 128), device="meta")
    with pytest.raises(ValueError, match="on"):
        apply_stencil(meta, wz.to("meta"), wp.to("meta"), spec)
