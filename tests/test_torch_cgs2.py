"""C1's CPU side (`lanczos_tpu_torch/ops/kernels/cgs2.py`): the plain
version `cgs2_plain` against the JAX package's `block_cgs2` and against
the two torch.mm passes block_lanczos ran before, the route and counters
on the CPU, the split schedule with a stub `total`, and the pure launch
plan the .cu rechecks.  The kernels themselves are held to `cgs2_plain`
on the card in tests/test_torch_cgs2_kernel.py."""

import importlib
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu_torch.methods import block_lanczos as bl
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels import cgs2 as c1
from lanczos_tpu_torch.utils import tracing

SHAPES = [(1, 1, 50), (3, 4, 200), (12, 8, 1000), (5, 3, 7)]  # (b, p, n)
DTYPES = [(np.float32, torch.float32, 2e-6), (np.float64, torch.float64, 1e-13)]


def jax_block_cgs2(dtype):
    """The JAX package's `block_cgs2`, the closure inside its block_lanczos
    (lanczos_tpu/methods/block_lanczos.py:339), on one device: its code
    object with `_pin` and `_pin_rep` the identity, as they are without a
    mesh."""
    mod = importlib.import_module("lanczos_tpu.methods.block_lanczos")
    fn = mod.block_lanczos
    fn = getattr(fn, "__wrapped__", fn)

    def find(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                if c.co_name == "block_cgs2":
                    return c
                found = find(c)
                if found is not None:
                    return found
        return None

    code = find(fn.__code__)
    cells = {"_pin": lambda x, extra_lead=1: x, "_pin_rep": lambda x: x,
             "dtype": jnp.dtype(dtype)}
    return types.FunctionType(code, mod.__dict__, "block_cgs2", None,
                              tuple(types.CellType(cells[v]) for v in code.co_freevars))


def inputs(b, p, n, np_dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, min(b * p, n))))[0].T
    basis = np.zeros((b * p, n))
    basis[:q.shape[0]] = q
    basis = basis[rng.permutation(b * p)].reshape(b, p, n).astype(np_dtype)
    w = rng.standard_normal((p, n)).astype(np_dtype)
    return w, basis


@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
@pytest.mark.parametrize("b,p,n", SHAPES)
def test_plain_matches_jax_block_cgs2(np_dtype, dtype, tol, b, p, n):
    w, basis = inputs(b, p, n, np_dtype, seed=b * p)
    got = c1.cgs2_plain(torch.from_numpy(w), torch.from_numpy(basis)).numpy()
    want = np.asarray(jax_block_cgs2(np_dtype)(jnp.asarray(w), jnp.asarray(basis),
                                               jnp.ones(b, np_dtype)))
    assert got.dtype == want.dtype == np_dtype
    assert np.abs(got - want).max() <= tol * np.abs(w).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,p,n", SHAPES)
def test_plain_is_the_two_mm_passes(dtype, b, p, n):
    """The A / B / C schedule in torch ops is the loop block_lanczos ran
    before C1, bit for bit, so it also stands for that loop's time."""
    w, basis = (torch.from_numpy(a).to(dtype) for a in inputs(b, p, n, np.float64))
    qf, x = basis.reshape(-1, n), w
    for _ in range(2):
        x = x - (qf @ x.T).T @ qf
    assert torch.equal(c1.cgs2_plain(w, basis), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_runs_plain_and_counts_calls(dtype):
    w, basis = (torch.from_numpy(a).to(dtype) for a in inputs(4, 8, 300, np.float64))
    tracing.reset()
    build.reset_launches()
    got = bl._cgs2(w, basis)
    assert torch.equal(got, c1.cgs2_plain(w, basis))
    assert bl._cgs2(w, basis[:0]) is w  # an empty basis is no call
    assert tracing.counters() == {"cgs2.calls": 1}  # cgs2.kernel stays 0
    assert build.LAUNCHES["cgs2"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_state_with_a_stub_total(dtype):
    """Two half-row shards, each in its own thread, whose `total` sums the
    two shards' coefficient blocks: together the one-device result."""
    w, basis = (torch.from_numpy(a).to(dtype) for a in inputs(6, 4, 400, np.float64))
    whole = c1.cgs2(w, basis)
    parts = [(w[:, :150], basis[:, :, :150]), (w[:, 150:], basis[:, :, 150:])]
    slots, barrier, out = [None, None], threading.Barrier(2), [None, None]

    def run(rank):
        def total(c):
            slots[rank] = c
            barrier.wait()
            s = slots[0] + slots[1]
            barrier.wait()
            return s
        out[rank] = c1.cgs2(*parts[rank], total)

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((torch.cat(out, dim=1) - whole).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("b", [1, 2, 7, 12, 17, 130])
def test_plan_fits_the_card(b, p, itemsize):
    plan = c1.cgs2_plan(b, p, itemsize)
    assert plan.pw % c1.COLS == 0 and p <= plan.pw < p + c1.COLS
    assert plan.slices == c1.WARPS // (plan.pw // c1.COLS)
    rows = min(b, plan.chunk) * p
    assert plan.chunk >= 1 and rows <= plan.slices * c1.slice_rows(itemsize)
    assert plan.chunks == -(-b // plan.chunk)
    assert 2 <= plan.stages <= c1.MAX_STAGES
    assert plan.smem == c1.smem_bytes(rows, plan.pw, plan.stages, itemsize) <= c1.SMEM
    assert plan.launches() == (3 if plan.chunks == 1 else 4 * plan.chunks)


def test_plan_at_the_eigsh_shapes():
    """f32 p = 8: every b the eigsh request runs (1..12) in one chunk, so
    three launches a call; 16 blocks at most; the ring as deep as fits."""
    for b in range(1, 17):
        assert c1.cgs2_plan(b, 8, 4).chunks == 1
    assert c1.cgs2_plan(17, 8, 4).chunks == 2
    assert c1.cgs2_plan(12, 8, 4).stages == 3 and c1.cgs2_plan(1, 8, 4).stages == 6
    assert c1.cgs2_plan(12, 8, 8).chunks == 2  # f64: 64 rows a chunk
    with pytest.raises(ValueError):
        c1.cgs2_plan(3, 17, 4)
    with pytest.raises(ValueError):
        c1.cgs2_plan(0, 8, 4)


def test_alignment_and_grid():
    assert c1.cgs2_aligned(1000, 4, (0, 4096)) and c1.cgs2_aligned(1000, 8, (0, 4096))
    assert not c1.cgs2_aligned(1001, 4, (0, 4096))  # rows not 16-byte aligned
    assert not c1.cgs2_aligned(1000, 4, (4, 4096))  # an operand not aligned
    assert c1.cgs2_blocks(10_485_760, 4, 132) == 132
    assert c1.cgs2_blocks(1000, 4, 132) == 8  # 128 positions a tile in f32
    assert c1.cgs2_blocks(1000, 8, 132) == 16  # 64 in f64
    assert c1.cgs2_blocks(3, 4, 132) == 1
