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
from lanczos_tpu_torch.ops.kernels import block_dense, build, stencil_gram
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
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_other_devices_raise_instead_of_falling_back():
    op, _ = _op_state(3, 2, torch.float32, "cpu")
    u = torch.empty((2,) + op.state_shape, device="meta")
    with pytest.raises(ValueError, match="on"):
        apply_stencil_pair(u, op.wz_t.to("meta"), op.wplane_s.to("meta"),
                           op.spec_e, op.spec_h)
    with pytest.raises(ValueError, match="on"):
        block_dense.block_mix(torch.eye(2, device="meta"), (u,))


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
