"""The CUDA kernels' wrappers: what runs on the CPU (dispatch, launch
counts, the tap table handed to the kernels) and, on a machine with an
NVIDIA GPU, each kernel against its plain torch version on the card.

The kernel tests carry the `cuda` marker and skip without a card; run
them there with `python -m pytest tests/test_torch_kernels.py -m cuda`.
"""

import functools

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
    BLOCK_SHARED_BYTES,
    MAX_TAPS_PER_COMP,
    STENCIL_SLOTS,
    StencilSpec,
    apply_stencil,
    apply_stencil_pair,
    apply_stencil_pair_plain,
    apply_stencil_plain,
    pair_plan,
    stencil_halos,
    stencil_plan,
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


def _k6_case(kind, p, dtype, device, zc=16, plane=256, seed=0):
    """A K6 spec, its weights and a (p, n_in, Zc, P) input: "27-point" is
    6 -> 3 with all 27 (dz, roll) combinations per output component,
    "laplacian" a 7-point 1 -> 1 set.  z-shifted taps have zero z-weights
    on the rows where the shift leaves the state (the operators' invariant
    that makes the Pallas kernel's clamped reads and the port's zeros
    agree)."""
    xc = 13
    if kind == "27-point":
        taps = tuple(
            (oc, (k + oc) % 6, dz, (-(dy * xc) - dx) % plane)
            for oc in range(3)
            for k, (dz, dy, dx) in enumerate(
                (a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
        )
        spec = StencilSpec(6, 3, taps, zc, plane)
    else:
        offs = ((0, 0), (-1, 0), (1, 0), (0, 1), (0, plane - 1), (0, xc),
                (0, plane - xc))
        spec = StencilSpec(1, 1, tuple((0, 0, dz, r) for dz, r in offs), zc, plane)
    rng = np.random.default_rng(seed)
    wz = rng.standard_normal((len(spec.taps), zc))
    for t, (_, _, dz, _) in enumerate(spec.taps):
        if dz:
            wz[t, 0 if dz == -1 else -1] = 0.0
    wp = rng.standard_normal((len(spec.taps), plane))
    x = rng.standard_normal((p, spec.n_in, zc, plane))
    return spec, *(torch.from_numpy(a).to(device, dtype) for a in (wz, wp, x))


def _op_state(n, p, dtype, device, seed=0):
    """The operator of an N^3 grid (n an int) or an (nx, ny, nz) grid, and
    a packed random (p, 6, Zc, P) state."""
    op = PallasMaxwellOperator.create(*((n,) * 3 if isinstance(n, int) else n),
                                      dtype=dtype, device=device)
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
    import scipy.sparse as sp

    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    windowed_from_scipy(sp.identity(300, format="csr"), device="cpu").mm(
        torch.ones((2, 300)))
    spec, wz, wp, x = _k6_case("laplacian", 1, torch.float32, "cpu")
    apply_stencil(x, wz, wp, spec)
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert set(build.LAUNCHES) == {
        "apply_stencil_pair", "block_mix", "block_grams",
        "apply_stencil_pair_gram", "fdtd_step", "block_grams_compensated",
        "windowed_spmm", "apply_stencil",
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
    op = PallasMaxwellOperator.create(6, 6, 6, device="cpu")
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
    """What the pair kernels' tap table still refuses: a paired half with
    an odd count of taps a component, and more than four.  Unpaired specs
    are no longer refused: the table encodes each half's paired flag, and
    K1, K4 and K5 take unpaired halves (K5 in its own kernel on the card;
    here their plain versions, the unfactored form)."""
    import dataclasses

    op = PallasMaxwellOperator.create(3, 3, 3, device="cpu")
    loose = dataclasses.replace(op.spec_e, paired=False)
    tab = list(tap_table(loose, op.spec_h))
    assert tab[-2:] == [0, 1]
    # component 0 gives its first tap to component 1: 3 and 5 taps
    moved = ((1,) + op.spec_e.taps[0][1:],) + op.spec_e.taps[1:]
    odd = dataclasses.replace(op.spec_e, taps=moved)
    with pytest.raises(ValueError, match="even count"):
        tap_table(odd, op.spec_h)
    five = dataclasses.replace(odd, paired=False)  # component 1's 5 taps
    with pytest.raises(ValueError, match="<= 4 taps"):
        tap_table(five, op.spec_h)
    x = torch.randn((2,) + op.state_shape, generator=torch.Generator().manual_seed(0))
    got = apply_stencil_pair(x, op.wz_t, op.wplane_s, loose, op.spec_h)
    torch.testing.assert_close(got, op.mm(x), rtol=1e-6, atol=1e-6)
    a = op.scaled(0.1)
    step = stencil_fdtd.fdtd_step(x, torch.empty_like(x), a.wz_t, a.wplane_s,
                                  loose, op.spec_h)
    torch.testing.assert_close(step, a.fdtd_step(x, torch.empty_like(x)),
                               rtol=1e-6, atol=1e-6)
    dst = torch.randn_like(x)
    v, g3 = stencil_gram.apply_stencil_pair_gram(x, dst.clone(), op.wz_t,
                                                 op.wplane_s, loose,
                                                 dataclasses.replace(op.spec_h, paired=False))
    v_ref, g3_ref = op.stencil_gram(x, dst.clone())
    torch.testing.assert_close(v, v_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g3, g3_ref, rtol=1e-5, atol=1e-5)


def test_launch_enters_the_tensors_device(monkeypatch):
    """build.launch: the entry point runs inside torch.cuda.device(t.device),
    the launch is counted once (or `count` times), and an error raises
    after the count."""
    import contextlib

    entered, calls = [], []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield
        entered.append("exit")

    class FakeLib:
        def lt_fake(self, *args):
            calls.append((tuple(entered), args))
            return 0

        def lt_broken(self, *args):
            return 700

    class OnCard:  # stands in for a tensor on the second card
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(build, "library", lambda: FakeLib())
    monkeypatch.setattr(build, "LAUNCHES", {"block_mix": 0, "windowed_spmm": 0})
    build.launch("block_mix", OnCard(), "lt_fake", 1, 2)
    assert calls == [((torch.device("cuda", 1),), (1, 2))]
    assert entered == [torch.device("cuda", 1), "exit"]
    assert build.LAUNCHES["block_mix"] == 1
    build.launch("windowed_spmm", OnCard(), "lt_fake", count=2)
    assert build.LAUNCHES["windowed_spmm"] == 2
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.launch("block_mix", OnCard(), "lt_broken")
    assert build.LAUNCHES["block_mix"] == 2


def test_every_launch_goes_through_the_device_guard():
    """No wrapper in ops/kernels/ reaches the kernel library itself: the
    only `library()` calls and `lt_*` attributes are build.py's, inside
    `launch` (and the Gram's blocks-per-SM query, which launches
    nothing)."""
    import ast
    from pathlib import Path

    kernels = Path(build.__file__).parent
    for path in sorted(kernels.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith("lt_"):
                assert path.name == "build.py", f"{path.name}: .{node.attr}"
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "library"):
                raise AssertionError(f"{path.name} calls build.library()")
        if path.name == "build.py":
            funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
            users = {name for name, f in funcs.items() for n in ast.walk(f)
                     if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "library"}
            assert users == {"launch", "gram_grid_cap"}


def test_grid_is_a_function_of_size_only():
    assert build.grid_blocks(1) == 1
    assert build.grid_blocks(256 * 7) == 7
    assert build.grid_blocks(10**9) == 1024
    h100 = 4 * 132  # kGramBlocksPerSM blocks on each of 132 SMs
    assert block_dense.gram_blocks(1, h100) == 1
    assert block_dense.gram_blocks(1024 * 7, h100) == 7
    # N=160 Maxwell: 28,114,944 elements a column; whole waves on 132 SMs
    assert block_dense.gram_blocks(6 * 176 * 26624, h100) == h100
    assert block_dense.gram_blocks(6 * 176 * 26624, 4 * 114) == 4 * 114


# K1/K5's plan on the geometries the card runs: N=3 (P=128, narrower than
# a strip), N=11, N=160 (the main path), and a non-cubic grid whose P=1152
# is no multiple of the strip width
PLAN_GEOMETRIES = [(3, 3, 3), (11, 11, 11), (160, 160, 160), (37, 24, 11)]


@functools.lru_cache(maxsize=None)
def _specs(geometry):
    from lanczos_tpu_torch.models.maxwell_pallas import _host_taps

    return _host_taps(*geometry, np.float32)[0]


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES)
def test_stencil_plan_covers_every_position_once(geometry, itemsize, p):
    """What K1/K5 rely on: the strips x z-chunks cover every (z, l) exactly
    once; each component's staged halo covers every tap's roll that reads
    it, in 16-byte units; the ring of staged rows fits a block's shared
    memory (227 KB) and is the plan's byte count."""
    spec_a, spec_b = _specs(geometry)
    zc, plane = spec_a.zc, spec_a.plane
    plan = pair_plan(spec_a, spec_b, p, itemsize, 132)
    count = np.zeros((zc, plane), np.int64)
    for s in range(plan.strips):
        for k in range(plan.chunks):
            l0, z0 = s * plan.width, k * plan.zchunk
            count[z0 : min(z0 + plan.zchunk, zc), l0 : min(l0 + plan.width, plane)] += 1
    assert (count == 1).all()
    vec = 16 // itemsize
    assert plan.width % vec == 0 and plan.width == 256 * plan.lanes_per_thread
    assert all(h % vec == 0 for h in plan.left + plan.right)
    for h, spec in enumerate((spec_a, spec_b)):
        for _, ic, _, r in spec.taps:
            c = 3 * (1 - h) + ic
            s = r if r <= plane // 2 else r - plane  # the tap reads lane l - s
            # the strip's lanes i in [0, width) read staged [left - s + i]
            assert 0 <= plan.left[c] - s
            assert plan.left[c] - s + plan.width <= plan.width + plan.left[c] + plan.right[c]
    assert plan.row == sum(plan.width + a + b for a, b in zip(plan.left, plan.right))
    assert plan.smem_bytes == (STENCIL_SLOTS * plan.row + 48) * itemsize <= BLOCK_SHARED_BYTES
    assert plan.row <= 8 * 256 * vec  # the copies a thread stages a row
    assert list(plan.ints) == [plan.width, plan.lanes_per_thread, plan.zchunk,
                               plan.strips, plan.chunks, plan.smem_bytes,
                               *plan.left, *plan.right]


def test_stencil_plan_at_the_main_path():
    """N=160 f32 on 132 SMs: 52 strips of 512 lanes (two a thread), in
    five z-chunks of 36 rows, 260 blocks in one wave of 2 blocks an SM;
    the halos are the y-pairs' xc=163 lanes, one side each half, rounded
    to 164.  f64 takes strips of 256."""
    spec_a, spec_b = _specs((160, 160, 160))
    left, right = stencil_halos(spec_a, spec_b)
    assert left == (163, 1, 163, 0, 0, 0) and right == (0, 0, 0, 163, 1, 163)
    plan = stencil_plan(176, 26624, left, right, 1, 4, 132)
    assert (plan.width, plan.lanes_per_thread, plan.strips) == (512, 2, 52)
    assert (plan.zchunk, plan.chunks) == (36, 5)
    assert plan.left == (164, 4, 164, 0, 0, 0)
    assert plan.smem_bytes == (6 * (6 * 512 + 4 * 164 + 2 * 4) + 48) * 4
    assert stencil_plan(176, 26624, left, right, 4, 4, 132) == plan
    f64 = stencil_plan(176, 26624, left, right, 1, 8, 132)
    assert (f64.width, f64.lanes_per_thread, f64.strips) == (256, 1, 104)
    narrow = stencil_plan(176, 26624, left, right, 1, 4, 132, width=256, zchunk=44)
    assert (narrow.lanes_per_thread, narrow.strips, narrow.chunks) == (1, 104, 4)
    with pytest.raises(ValueError, match="strip"):
        stencil_plan(176, 26624, left, right, 1, 4, 132, width=768)
    with pytest.raises(ValueError, match="shared memory"):
        stencil_plan(176, 26624, [26624 // 2] * 6, right, 1, 8, 132, width=512)


def test_tap_table_and_plan_are_cached():
    """A loop of K1/K5 launches rebuilds neither its tap table nor its
    plan."""
    spec_a, spec_b = _specs((11, 11, 11))
    assert tap_table(spec_a, spec_b) is tap_table(spec_a, spec_b)
    plan = pair_plan(spec_a, spec_b, 1, 4, 132)
    assert plan is pair_plan(spec_a, spec_b, 1, 4, 132)
    assert plan.ints is plan.ints


# K3/K7's launch: the register tile from (K, p), exact at the main path's
# calls ((), b and (q,), v with include_zz: K = p and 2p) and the 12 x 4
# tile elsewhere
@pytest.mark.parametrize("K,p,tile", [
    (1, 1, (1, 1)), (2, 1, (2, 1)), (3, 1, (12, 4)), (4, 4, (4, 4)),
    (8, 4, (8, 4)), (4, 1, (12, 4)), (12, 1, (12, 4)), (13, 1, (12, 4)),
    (2, 2, (12, 4)), (12, 4, (12, 4)), (6, 3, (12, 4)), (27, 9, (12, 4)),
])
def test_gram_tile_is_exact_on_the_main_path(K, p, tile):
    assert block_dense.gram_tile(K, p) == tile


@pytest.mark.parametrize("S,itemsize,offsets,vec", [
    (6 * 176 * 26624, 4, (0, 0), 4),  # N=160 Maxwell f32: float4 loads
    (6 * 176 * 26624, 8, (0, 0), 2),  # f64: double2 loads
    (1001, 4, (0, 0), 1),             # a flat state, n % 4 != 0
    (1001, 8, (0, 0), 1),             # 8008 bytes a row: not a multiple of 16
    (1000, 4, (0, 4), 1),             # one operand at an odd element offset
    (1000, 4, (0, 16), 4),            # offset by a whole 16 bytes
    (1000, 8, (8, 0), 1),
])
def test_gram_vector_width_follows_size_and_alignment(S, itemsize, offsets, vec):
    ptrs = [4096 + o for o in offsets]
    assert block_dense.gram_vector_width(S, itemsize, ptrs) == vec


def test_gram_vector_width_of_split_views():
    """Rows of a split buffer start at its row stride: an odd row length
    misaligns every other row, an odd leading row every row after it."""
    def width(parts, z):
        return block_dense.gram_vector_width(
            z[0].numel(), z.element_size(), [t.data_ptr() for t in (*parts, z)])

    even = torch.zeros((3, 1024))
    assert width(even.split(1)[:2], even[2:]) == 4
    odd = torch.zeros((3, 1023))
    assert width(odd.split(1)[:2], odd[2:]) == 1
    flat = torch.zeros(1 + 2 * 1024)
    x, z = flat[1:1025].view(1, 1024), flat[1025:].view(1, 1024)
    assert width((x,), z) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["rectangular", "unstructured", "rcm_band",
                                  "997_rows", "wide_band"])
def test_k8_plans_keep_every_slot_in_its_band(name, dtype):
    """What K8 gathers with no bounds logic: every plane slot's column lies
    in its group's band [wb, wb + wsz), every band below n128, and an empty
    slot (value 0) reads index 0 of its plane's window; the plain product
    agrees with scipy's."""
    from lanczos_tpu_torch.ops.kernels.window_ell import (
        plane_columns,
        windowed_spmm,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    a, kw = _k8_case(name)
    A = windowed_from_scipy(a, dtype=dtype, ppc_cap=256, device="cpu", **kw)
    cols = plane_columns(A)
    C = cols.shape[0]
    base = A.wb.long()[torch.arange(C) // (A.cpb * A.spg)].view(C, 1, 1)
    assert bool(((cols >= base) & (cols < base + A.wsz)).all())
    assert int(A.wb.max()) + A.wsz <= A.n128
    empty = A.planes_data.view(cols.shape) == 0
    assert bool((A.planes_lidx.view(cols.shape)[empty] == 0).all())
    x = np.random.default_rng(2).standard_normal((1, a.shape[1]))
    X = A.pack(A.permute(torch.from_numpy(x).to(dtype)))
    y = A.unpermute(A.unpack(windowed_spmm(A, X), 1)).double().numpy()
    ref = (a @ x.T).T
    tol = 2e-6 if dtype == torch.float32 else 1e-13
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


def test_plan_check_refuses_slots_outside_the_band():
    import scipy.sparse as sp

    from lanczos_tpu_torch.ops.window_ell import (
        WindowedEllMatrix,
        windowed_from_scipy,
    )

    A = windowed_from_scipy(sp.identity(300, format="csr"), device="cpu")
    geom = dict(n_rows_true=A.n_rows_true, n_cols_true=A.n_cols_true,
                ppc=A.ppc, cpb=A.cpb, spg=A.spg, wsz=A.wsz, n128=A.n128,
                nnz_true=A.nnz_true, device="cpu")
    arrays = [t.numpy().copy() for t in (A.planes_data, A.planes_lidx,
                                         A.planes_off, A.wb)]
    WindowedEllMatrix(*arrays, None, **geom)
    bad_off = arrays[2].copy()
    bad_off[0] = A.wsz // 128 - 1  # its slots would reach past the band
    with pytest.raises(ValueError, match="band"):
        WindowedEllMatrix(*arrays[:2], bad_off, arrays[3], None, **geom)
    bad_wb = arrays[3].copy()
    bad_wb[0] = A.n128 - A.wsz + 128
    with pytest.raises(ValueError, match="band"):
        WindowedEllMatrix(*arrays[:3], bad_wb, None, **geom)


# -- on the card: each kernel against its plain version -------------------


# K1/K5's strip kernel on the card: the main path (N=160, p=4 and 1), a
# plane narrower than a strip (N=3, P=128), a non-cubic grid whose P=1152
# is no multiple of the strip, and p=5
STRIP_CASES = [(6, 4), (11, 3), (3, 1), (3, 2), ((37, 24, 11), 3), (6, 5),
               (160, 1), (160, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", STRIP_CASES)
def test_k1_stencil_kernel_vs_plain(cuda, n, p, dtype):
    op, u = _op_state(n, p, dtype, cuda)
    before = build.LAUNCHES["apply_stencil_pair"]
    got = op.mm(u)
    torch.cuda.synchronize()
    assert build.LAUNCHES["apply_stencil_pair"] == before + 1
    want = apply_stencil_pair_plain(u, op.wz_t, op.wplane_s, op.spec_e, op.spec_h)
    _close(got, want, dtype)
    assert torch.equal(got, op.mm(u))  # no cross-block sums: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,zc,plane", [
    ("27-point", 16, 256), ("laplacian", 16, 256), ("27-point", 13, 256),
    ("laplacian", 9, 128),
])
@pytest.mark.parametrize("p", [1, 3, 5])
def test_k6_apply_stencil_vs_plain(cuda, kind, zc, plane, p, dtype):
    spec, wz, wp, x = _k6_case(kind, p, dtype, cuda, zc=zc, plane=plane)
    before = build.LAUNCHES["apply_stencil"]
    got = apply_stencil(x, wz, wp, spec)
    torch.cuda.synchronize()
    assert build.LAUNCHES["apply_stencil"] == before + 1
    _close(got, apply_stencil_plain(x, wz, wp, spec), dtype)
    _close(apply_stencil(x[0], wz, wp, spec), got[0], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(6, 4), (11, 3), (3, 1)])
def test_k6_unpaired_pair_vs_k1(cuda, n, p, dtype):
    """An unpaired curl pair is two K6 launches and no K1, equal to K1's
    factored product to rounding."""
    import dataclasses

    op, u = _op_state(n, p, dtype, cuda)
    loose = [dataclasses.replace(s, paired=False) for s in (op.spec_e, op.spec_h)]
    build.reset_launches()
    got = apply_stencil_pair(u, op.wz_t, op.wplane_s, *loose)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["apply_stencil"], build.LAUNCHES["apply_stencil_pair"]) == (2, 0)
    _close(got, op.mm(u), dtype)
    _close(got, apply_stencil_pair_plain(u, op.wz_t, op.wplane_s, *loose), dtype)


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


def _gram_check(xs, z, include_zz, dtype, compensated=False):
    """K3 (or K7) against its plain version, one launch, bit-equal on a
    repeat."""
    name = "block_grams_compensated" if compensated else "block_grams"
    fn = getattr(block_dense, name)
    before = build.LAUNCHES[name]
    got = fn(xs, z, include_zz=include_zz)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    want = getattr(block_dense, name + "_plain")(xs, z, include_zz=include_zz)
    if compensated:
        got64, want64 = got.double().cpu(), want.double().cpu()
        assert (got64 - want64).abs().max().item() <= K7_RTOL * want64.abs().max().item()
    else:
        _close(got, want, dtype)
    assert torch.equal(got, fn(xs, z, include_zz=include_zz))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("n", [1001, 4099])
def test_k3_flat_states_of_odd_length(cuda, n, p, dtype):
    """Flat (p, n) states with n % 4 != 0 (the ELL and matrix operators'
    states) take the scalar instantiation, on the main path's tiles."""
    g = torch.Generator(device="cpu").manual_seed(n + p)
    q, v = (torch.randn((p, n), generator=g, dtype=dtype).to(cuda) for _ in range(2))
    assert block_dense.gram_vector_width(n, q.element_size(),
                                         [q.data_ptr(), v.data_ptr()]) == 1
    _gram_check((q,), v, True, dtype)
    _gram_check((), v, True, dtype)
    if dtype == torch.float32:
        _gram_check((q,), v, True, dtype, compensated=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 4])
def test_k3_operands_at_an_odd_element_offset(cuda, p, dtype):
    """q and v split from one buffer with an odd leading row: 16-byte rows
    (n = 4096) whose pointers are 4 (f32) or 8 (f64) bytes off alignment."""
    n = 4096
    g = torch.Generator(device="cpu").manual_seed(7)
    buf = torch.randn((1 + 2 * p, n), generator=g, dtype=dtype).to(cuda)
    flat = buf.view(-1)[1 : 1 + 2 * p * n]
    q, v = flat[: p * n].view(p, n), flat[p * n :].view(p, n)
    assert block_dense.gram_vector_width(n, q.element_size(),
                                         [q.data_ptr(), v.data_ptr()]) == 1
    _gram_check((q,), v, True, dtype)
    _gram_check((q, q, v), v, False, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("K", [1, 2, 3, 12, 20])
def test_k3_every_tile(cuda, K, p, dtype):
    """K rows against p columns on the 16-byte path: the exact tiles at
    K = p, 2p, the 12 x 4 tile otherwise, K = 20 over two tiles of
    rows."""
    _, z = _op_state(6, p, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(K)
    rows = [K // 3, K // 3, K - 2 * (K // 3)]
    xs = [torch.randn((r,) + tuple(z.shape[1:]), generator=g, dtype=dtype).to(cuda)
          for r in rows if r]
    assert block_dense.gram_vector_width(
        z[0].numel(), z.element_size(), [x.data_ptr() for x in (*xs, z)]) > 1
    _gram_check(xs, z, False, dtype)
    if dtype == torch.float32:
        _gram_check(xs, z, False, dtype, compensated=True)


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
@pytest.mark.parametrize("n,p", STRIP_CASES + [(6, 1)])
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
    assert torch.equal(got, a.fdtd_step(u, torch.empty_like(u)))
    with pytest.raises(ValueError, match="out must not be u"):
        a.fdtd_step(u, u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loose", ["e", "h", "both"])
@pytest.mark.parametrize("n,p", [(6, 3), (3, 1), ((37, 24, 11), 2)])
def test_k5_unpaired_vs_plain(cuda, n, p, loose, dtype):
    """K5 with an unpaired half sums that half's taps one at a time in its
    own kernel: one launch, held to the plain version."""
    import dataclasses

    op, u = _op_state(n, p, dtype, cuda)
    a = op.scaled(0.01)
    specs = [dataclasses.replace(s, paired=loose not in (k, "both"))
             for k, s in (("e", a.spec_e), ("h", a.spec_h))]
    build.reset_launches()
    got = stencil_fdtd.fdtd_step(u, torch.empty_like(u), a.wz_t, a.wplane_s, *specs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fdtd_step"] == 1
    want = stencil_fdtd.fdtd_step_plain(u, torch.empty_like(u), a.wz_t,
                                        a.wplane_s, *specs)
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loose", ["e", "h", "both"])
@pytest.mark.parametrize("n,p", [(6, 4), (11, 3)])
def test_k4_unpaired_vs_plain(cuda, n, p, loose, dtype):
    """K4 with an unpaired half: K3, then two K6 launches into dst, then
    K3, and no K4; v is dst and matches the plain version, g3 too."""
    import dataclasses

    op, q = _op_state(n, p, dtype, cuda)
    _, dst = _op_state(n, p, dtype, cuda, seed=5)
    specs = [dataclasses.replace(s, paired=loose not in (k, "both"))
             for k, s in (("e", op.spec_e), ("h", op.spec_h))]
    want_v, want_g3 = stencil_gram.apply_stencil_pair_gram_plain(
        q, dst.clone(), op.wz_t, op.wplane_s, *specs)
    build.reset_launches()
    v, g3 = stencil_gram.apply_stencil_pair_gram(q, dst, op.wz_t, op.wplane_s, *specs)
    torch.cuda.synchronize()
    assert v.data_ptr() == dst.data_ptr()
    assert {k: c for k, c in build.LAUNCHES.items() if c} == {
        "block_grams": 2, "apply_stencil": 2}
    _close(v, want_v, dtype)
    _close(g3, want_g3, dtype)


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


def _k8_case(name):
    """Small odd geometries for K8 (as chip_smoke.py's): rectangular,
    unstructured (several windows a chunk, greedy packing), an
    RCM-permuted band, 997 rows of a band."""
    import scipy.sparse as sp

    def band(n, k):
        return sp.diags([np.full(n - abs(o), 2.0 if o == 0 else -1.0)
                         for o in range(-k, k + 1)], list(range(-k, k + 1)),
                        format="csr")

    if name == "rectangular":
        return sp.random(300, 900, density=0.01, random_state=3, format="csr"), {}
    if name == "unstructured":
        return sp.random(500, 500, density=0.02, random_state=2, format="csr"), {}
    if name == "rcm_band":
        perm = np.random.default_rng(5).permutation(1500)
        return band(1500, 3)[perm][:, perm].tocsr(), dict(reorder="rcm")
    if name == "wide_band":
        # unstructured 100k x 100k, one nonzero a row: its band spans the
        # whole matrix, 100,224 elements
        n = 100_000
        rng = np.random.default_rng(11)
        return sp.csr_matrix((rng.standard_normal(n), (np.arange(n), rng.integers(0, n, n))),
                             shape=(n, n)), {}
    return band(999, 1)[:997, :999].tocsr(), {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["rectangular", "unstructured", "rcm_band", "997_rows"])
@pytest.mark.parametrize("p", [1, 3, 12])
def test_k8_windowed_spmm_vs_plain_and_scipy(cuda, name, dtype, p):
    """K8 against its plain version (KERNEL_RTOL) and against scipy's f64
    product (2e-6 of scale in f32, 1e-13 in f64).  p=12 takes two column
    groups of the kernel, so two launches."""
    from lanczos_tpu_torch.ops.kernels.window_ell import (
        windowed_spmm,
        windowed_spmm_plain,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    a, kw = _k8_case(name)
    A = windowed_from_scipy(a, dtype=dtype, ppc_cap=256, device=cuda, **kw)
    x = np.random.default_rng(0).standard_normal((p, a.shape[1]))
    X = A.pack(A.permute(torch.from_numpy(x).to(cuda, dtype)))
    before = build.LAUNCHES["windowed_spmm"]
    got = windowed_spmm(A, X)
    torch.cuda.synchronize()
    assert build.LAUNCHES["windowed_spmm"] == before + (1 if p <= 8 else 2)
    want = windowed_spmm_plain(A, X)
    err = (got - want).abs().max().item()
    assert err <= KERNEL_RTOL[dtype] * want.abs().max().item()
    assert torch.count_nonzero(got[:, A.n_rows_true:]) == 0
    y = A.unpermute(A.unpack(got, p)).double().cpu().numpy()
    ref = (a @ x.T).T
    tol = 2e-6 if dtype == torch.float32 else 1e-13
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 2])
def test_k8_wide_band_vs_plain_and_scipy(cuda, dtype, p):
    """An unstructured 100k x 100k matrix, whose band spans every column:
    held to plain and scipy."""
    from lanczos_tpu_torch.ops.kernels.window_ell import (
        windowed_spmm,
        windowed_spmm_plain,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    a, kw = _k8_case("wide_band")
    A = windowed_from_scipy(a, dtype=dtype, ppc_cap=256, device=cuda, **kw)
    x = np.random.default_rng(1).standard_normal((p, a.shape[1]))
    X = A.pack(torch.from_numpy(x).to(cuda, dtype))
    before = build.LAUNCHES["windowed_spmm"]
    got = windowed_spmm(A, X)
    torch.cuda.synchronize()
    assert build.LAUNCHES["windowed_spmm"] == before + 1
    want = windowed_spmm_plain(A, X)
    assert (got - want).abs().max().item() <= KERNEL_RTOL[dtype] * want.abs().max().item()
    y = A.unpack(got, p).double().cpu().numpy()
    ref = (a @ x.T).T
    tol = 2e-6 if dtype == torch.float32 else 1e-13
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.cuda
def test_k8_with_unaligned_x_and_out(cuda):
    """x at an odd element offset, and y written with scalar stores where
    it is not 16-byte aligned."""
    from lanczos_tpu_torch.ops.kernels.window_ell import (
        windowed_spmm,
        windowed_spmm_plain,
    )
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    a, kw = _k8_case("rcm_band")
    A = windowed_from_scipy(a, ppc_cap=256, device=cuda, **kw)
    flat = torch.randn(2 * A.n128 + 2, device=cuda)
    X = flat[1 : 1 + A.n128].view(1, -1)
    out = flat[A.n128 + 2 :].view(1, -1)
    before = build.LAUNCHES["windowed_spmm"]
    got = windowed_spmm(A, X, out)
    torch.cuda.synchronize()
    assert build.LAUNCHES["windowed_spmm"] == before + 1
    _close(got, windowed_spmm_plain(A, X), torch.float32)


@pytest.mark.cuda
def test_k8_refuses_an_aliased_out(cuda):
    import scipy.sparse as sp

    from lanczos_tpu_torch.ops.kernels.window_ell import windowed_spmm
    from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

    A = windowed_from_scipy(sp.identity(300, format="csr"), device=cuda)
    X = A.pack(torch.ones((2, 300), device=cuda))
    for out in (X, X.view(-1)[64 : 64 + A.n128].view(1, -1).expand(2, -1)):
        with pytest.raises(ValueError, match="alias"):
            windowed_spmm(A, X, out)
    with pytest.raises(TypeError, match="planes"):
        windowed_spmm(A, X.double())
