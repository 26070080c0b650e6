"""The CUDA kernels' wrappers: what runs on the CPU (dispatch, launch
counts, the tap table handed to the kernels) and, on a machine with an
NVIDIA GPU, each kernel against its plain torch version on the card.

The kernel tests carry the `cuda` marker and skip without a card; run
them there with `python -m pytest tests/test_torch_kernels.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.ops.kernels import (
    block_dense,
    build,
    stencil_fdtd,
    stencil_gram,
)
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    MAX_TAPS_PER_COMP,
    apply_stencil_pair,
    apply_stencil_pair_plain,
    tap_table,
)

# kernel vs plain on the card: the same arithmetic summed in another
# order (per-thread partials, then a block tree, then block order), so
# f32 agrees to ~1e-5 of the result's scale, f64 to ~1e-12
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# K7 against its plain version: both sum in f64 (in other orders) and
# round to f32 once, so they differ by at most an ulp or two of f32
K7_RTOL = 3e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel vs plain torch version")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.double().cpu(), want.double().cpu()
    tol = KERNEL_RTOL[dtype] * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def _op_state(n, p, dtype, device, seed=0):
    op = PallasMaxwellOperator.create(n, n, n, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((p, op.n))).to(dtype)
    return op, op.pack(x.to(device))


# -- CPU: dispatch and host-side contract -----------------------------------


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    build.reset_launches()
    op, u = _op_state(3, 2, torch.float32, "cpu")
    op.mm(u)
    block_dense.block_mix(torch.eye(2), (u,))
    block_dense.block_grams((u,), u, include_zz=True)
    op.stencil_gram(u.clone(), u.clone())
    op.scaled(0.1).fdtd_step(u, torch.empty_like(u))
    block_dense.block_grams_compensated((u,), u, include_zz=True)
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert set(build.LAUNCHES) == {
        "apply_stencil_pair", "block_mix", "block_grams",
        "apply_stencil_pair_gram", "fdtd_step", "block_grams_compensated",
    }


def test_other_devices_raise_instead_of_falling_back():
    op, _ = _op_state(3, 2, torch.float32, "cpu")
    u = torch.empty((2,) + op.state_shape, device="meta")
    with pytest.raises(ValueError, match="on"):
        apply_stencil_pair(u, op.wz_t.to("meta"), op.wplane_s.to("meta"),
                           op.spec_e, op.spec_h)
    with pytest.raises(ValueError, match="on"):
        block_dense.block_mix(torch.eye(2, device="meta"), (u,))
    with pytest.raises(ValueError, match="on"):
        stencil_fdtd.fdtd_step(u, torch.empty_like(u), op.wz_t.to("meta"),
                               op.wplane_s.to("meta"), op.spec_e, op.spec_h)
    with pytest.raises(ValueError, match="on"):
        block_dense.block_grams_compensated((u,), u)


def test_tap_table_encodes_the_specs():
    op = PallasMaxwellOperator.create(6, 6, 6)
    tab = list(tap_table(op.spec_e, op.spec_h))
    stride = 1 + 4 * MAX_TAPS_PER_COMP
    for c in range(6):
        h, oc = divmod(c, 3)
        spec = (op.spec_e, op.spec_h)[h]
        rec = tab[c * stride : (c + 1) * stride]
        n = rec[0]
        idx = [t for t, tp in enumerate(spec.taps) if tp[0] == oc]
        assert n == len(idx) == 4
        t, ic, dz, r = (rec[1 + k * 4 : 1 + k * 4 + n] for k in range(4))
        assert t == idx
        assert ic == [3 * (1 - h) + spec.taps[i][1] for i in idx]
        assert dz == [spec.taps[i][2] for i in idx]
        assert r == [spec.taps[i][3] % spec.plane for i in idx]
        assert all(0 <= x < spec.plane for x in r)


def test_unpaired_specs_are_refused():
    import dataclasses

    op = PallasMaxwellOperator.create(3, 3, 3)
    loose = dataclasses.replace(op.spec_e, paired=False)
    u = torch.zeros((1,) + op.state_shape)
    with pytest.raises(ValueError, match="paired"):
        apply_stencil_pair(u, op.wz_t, op.wplane_s, loose, op.spec_h)
    with pytest.raises(ValueError, match="paired"):
        tap_table(loose, op.spec_h)


def test_grid_is_a_function_of_size_only():
    assert build.grid_blocks(1) == 1
    assert build.grid_blocks(256 * 7) == 7
    assert build.grid_blocks(10**9) == 1024


# -- on the card: each kernel against its plain version -------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(6, 4), (11, 3), (3, 1)])
def test_k1_stencil_kernel_vs_plain(cuda, n, p, dtype):
    op, u = _op_state(n, p, dtype, cuda)
    before = build.LAUNCHES["apply_stencil_pair"]
    got = op.mm(u)
    torch.cuda.synchronize()
    assert build.LAUNCHES["apply_stencil_pair"] == before + 1
    want = apply_stencil_pair_plain(u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,p_out,inplace", [
    ((4,), 4, False), ((4, 4), 4, False), ((4, 4, 4), 4, True),
    ((3, 3, 3), 3, True), ((8, 8), 8, False), ((5,), 17, False),
])
def test_k2_block_mix_vs_plain(cuda, rows, p_out, inplace, dtype):
    _, z = _op_state(6, 1, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(1)
    xs = [torch.randn((r,) + tuple(z.shape[1:]), generator=g, dtype=dtype).to(cuda) for r in rows]
    coeffs = torch.randn(sum(rows), p_out, generator=g, dtype=dtype).to(cuda)
    want = block_dense.block_mix_plain(coeffs, [x.clone() for x in xs])
    got = block_dense.block_mix(coeffs, xs, inplace=inplace)
    torch.cuda.synchronize()
    if inplace:
        assert got.data_ptr() == xs[0].data_ptr()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,p,include_zz", [
    ((), 4, True), ((4,), 4, True), ((4, 4, 4), 4, False), ((3,), 3, True),
    ((9, 9), 9, True),
])
def test_k3_block_grams_vs_plain(cuda, rows, p, include_zz, dtype):
    _, z = _op_state(11, p, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    xs = [torch.randn((r,) + tuple(z.shape[1:]), generator=g, dtype=dtype).to(cuda) for r in rows]
    got = block_dense.block_grams(xs, z, include_zz=include_zz)
    want = block_dense.block_grams_plain(xs, z, include_zz=include_zz)
    _close(got, want, dtype)
    # deterministic: the same inputs give the same bits
    assert torch.equal(got, block_dense.block_grams(xs, z, include_zz=include_zz))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(6, 4), (11, 3), (6, 8), (6, 1)])
def test_k4_stencil_gram_vs_plain(cuda, n, p, dtype):
    op, q = _op_state(n, p, dtype, cuda)
    _, dst = _op_state(n, p, dtype, cuda, seed=5)
    want_v, want_g3 = stencil_gram.apply_stencil_pair_gram_plain(
        q, dst.clone(), op.wz_t, op.wplane_s, op.spec_e, op.spec_h
    )
    v, g3 = op.stencil_gram(q, dst)
    torch.cuda.synchronize()
    assert v.data_ptr() == dst.data_ptr()
    _close(v, want_v, dtype)
    _close(g3, want_g3, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(6, 4), (11, 3), (3, 1), (6, 1), (6, 5)])
def test_k5_fdtd_step_vs_plain(cuda, n, p, dtype):
    op, u = _op_state(n, p, dtype, cuda)
    a = op.scaled(0.01)
    keep = u.clone()
    out = torch.empty_like(u)
    before = build.LAUNCHES["fdtd_step"]
    got = a.fdtd_step(u, out)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fdtd_step"] == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(u, keep)  # u is only read
    want = stencil_fdtd.fdtd_step_plain(u, torch.empty_like(u), a.wz_t,
                                        a.wplane_s, a.spec_e, a.spec_h)
    _close(got, want, dtype)
    with pytest.raises(ValueError, match="out must not be u"):
        a.fdtd_step(u, u)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,p,include_zz", [
    ((), 4, True), ((4,), 4, True), ((4, 4, 4), 4, False), ((3,), 3, True),
    ((9, 9), 9, True), ((1,), 1, True),
])
def test_k7_block_grams_compensated_vs_plain(cuda, rows, p, include_zz):
    _, z = _op_state(11, p, torch.float32, cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    xs = [torch.randn((r,) + tuple(z.shape[1:]), generator=g).to(cuda) for r in rows]
    before = build.LAUNCHES["block_grams_compensated"]
    got = block_dense.block_grams_compensated(xs, z, include_zz=include_zz)
    torch.cuda.synchronize()
    assert build.LAUNCHES["block_grams_compensated"] == before + 1
    assert got.dtype == torch.float32
    want = block_dense.block_grams_compensated_plain(xs, z, include_zz=include_zz)
    got, want = got.double().cpu(), want.double().cpu()
    assert (got - want).abs().max().item() <= K7_RTOL * want.abs().max().item()
    assert torch.equal(got, block_dense.block_grams_compensated(
        xs, z, include_zz=include_zz).double().cpu())


@pytest.mark.cuda
def test_k7_reaches_the_f64_oracle(cuda):
    """Inputs spread over e^+-6, where a plain f32 Gram loses ~10x more:
    K7, an f64 sum rounded once to f32, stays within 1e-7 of the f64
    Gram's scale (one rounding is 2^-24 = 6e-8; tests/test_block_dense.py
    holds the JAX kernel to 5e-7)."""
    rng = np.random.default_rng(1234)
    p, n = 4, 1 << 20
    x, z = ((rng.standard_normal((p, n)) * np.exp(rng.uniform(-6, 6, (p, n))))
            .astype(np.float32) for _ in range(2))
    exact = x.astype(np.float64) @ z.astype(np.float64).T
    got = block_dense.block_grams_compensated(
        (torch.from_numpy(x).to(cuda),), torch.from_numpy(z).to(cuda)
    ).cpu().numpy()
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-7
    with pytest.raises(ValueError, match="float32"):
        block_dense.block_grams_compensated((), torch.zeros((2, 8), device=cuda,
                                                            dtype=torch.float64),
                                            include_zz=True)
