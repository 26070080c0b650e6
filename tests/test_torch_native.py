"""The port's C++ host engine (lanczos_tpu_torch/native, built by g++
here as on the card's machine) against its NumPy paths and against the
JAX package's engine (tests/test_native.py for the port).

Tolerances:
- `ell_from_csr`, `halo_ell_from_csr` and the windowed planner: bit-equal
  to the port's NumPy paths and to the JAX package's arrays (one rounding
  of the same f64 or f32 value, the same grouping);
- `maxwell_ell`: the column indices equal those of scipy's canonical
  `assemble_maxwell_A` -> `ell_from_scipy` bit for bit; its values are the
  taps' f64 product rounded once, so in f32 they equal the JAX engine's
  (the same product) bit for bit, and against scipy's product of the same
  factors in another order they are within 4 ulp of f64 (rtol 1e-15) and
  2e-7 of scale in f32.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lanczos_tpu.models import maxwell as jmax
from lanczos_tpu.ops import formats as jfmt
from lanczos_tpu.ops.pallas import window_ell as jwe
from lanczos_tpu_torch import native
from lanczos_tpu_torch.models import maxwell as tmax
from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
from lanczos_tpu_torch.ops import formats as tfmt
from lanczos_tpu_torch.ops import window_ell as twe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
DTYPES = [np.float32, np.float64]


def _torch_dtype(dtype):
    return torch.float32 if dtype == np.float32 else torch.float64


def _planner_cases():
    """tests/test_native.py's matrices: banded, scattered, an arrow (several
    windows a chunk) and a rectangular one."""
    arrow = sp.lil_matrix((300, 300))
    arrow.setdiag(2.0)
    arrow[0, :] = 1.0
    arrow[:, 0] = 1.0
    return {
        "banded": laplacian_2d_scipy(31, 23),
        "scattered": sp.random(500, 500, density=0.02, random_state=1, format="csr"),
        "arrow": arrow.tocsr(),
        "rectangular": sp.random(260, 900, density=0.01, random_state=2,
                                 format="csr"),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["laplacian", "scattered_f64_data"])
def test_ell_from_csr_bit_equal_to_numpy_and_jax(name, dtype):
    if name == "laplacian":
        a = laplacian_2d_scipy(9, 7).tocsr()
    else:  # f64 values that round in f32
        a = sp.random(70, 50, density=0.1, random_state=3, format="csr")
    got = tfmt.ell_from_scipy(a, dtype=_torch_dtype(dtype), **CPU)
    plain = tfmt.ell_from_scipy(a, dtype=_torch_dtype(dtype), packer="numpy", **CPU)
    assert torch.equal(got.data, plain.data) and torch.equal(got.indices, plain.indices)
    ref = jfmt.ell_from_scipy(a, dtype=jnp.dtype(dtype))  # rows padded to 8
    n = a.shape[0]
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data)[:n])
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices)[:n])
    assert got.data.dtype == _torch_dtype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(_planner_cases()))
def test_window_pack_bit_equal_to_numpy_and_jax(name, dtype):
    a = _planner_cases()[name].tocsr()
    a.sum_duplicates()
    a.data = a.data.astype(dtype)
    n = a.shape[0]
    got = twe._pack_planes(a.indptr, a.indices, a.data, n, 10**5)
    plain = twe._pack_planes(a.indptr, a.indices, a.data, n, 10**5, packer="numpy")
    ref = jwe._pack_planes(a.indptr, a.indices, a.data, n, 10**5)
    assert native.window_pack_count(a.indptr, a.indices, n) == got[0].shape[1]
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == p.dtype == r.dtype and g.shape == p.shape == r.shape
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)


def test_window_pack_plan_error_above_ppc_cap():
    a = sp.random(400, 400, density=0.05, random_state=4, format="csr")
    a.data = a.data.astype(np.float32)
    ppc = native.window_pack_count(a.indptr, a.indices, 400)
    assert ppc > 1
    for packer in ("native", "numpy"):
        with pytest.raises(twe.PlanError, match="exceeds cap"):
            twe._pack_planes(a.indptr, a.indices, a.data, 400, ppc - 1, packer=packer)
    twe._pack_planes(a.indptr, a.indices, a.data, 400, ppc)


def test_windowed_plans_equal_for_both_packers():
    a = sp.random(900, 900, density=0.01, random_state=6, format="csr") + sp.eye(900)
    a = a.astype(np.float32)
    got = twe.windowed_from_scipy(a, cpb=2, spg=2, ppc_cap=256, **CPU)
    plain = twe.windowed_from_scipy(a, cpb=2, spg=2, ppc_cap=256, packer="numpy", **CPU)
    for name in ("planes_data", "planes_lidx", "planes_off", "wb", "perm"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert (got.ppc, got.wsz) == (plain.ppc, plain.wsz)


def _dense(data, idx, n):
    d = np.zeros((n, n), np.float64)
    rows = np.repeat(np.arange(n), data.shape[1])
    np.add.at(d, (rows, idx[:n].reshape(-1)), data[:n].reshape(-1))
    return d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(3, 3, 3), (5, 5, 5), (4, 3, 5)])
def test_maxwell_ell_matches_scipy_and_jax(grid, dtype):
    tdt = _torch_dtype(dtype)
    got = tmax.maxwell_ell_operator(*grid, dtype=tdt, **CPU)
    plain = tmax.maxwell_ell_operator(*grid, dtype=tdt, packer="numpy", **CPU)
    assert got.width == 4 and got.shape == plain.shape
    # the rows and column order of scipy's canonical A, bit for bit
    assert torch.equal(got.indices, plain.indices)
    scale = plain.data.abs().max().item()
    rtol = 1e-15 if dtype == np.float64 else 2e-7
    np.testing.assert_allclose(got.data.numpy(), plain.data.numpy(), rtol=0,
                               atol=rtol * scale)
    a_ref = tmax.assemble_maxwell_A(*grid).toarray()
    n = a_ref.shape[0]
    np.testing.assert_allclose(_dense(got.data.numpy(), got.indices.numpy(), n),
                               a_ref, rtol=0, atol=(1e-15 if dtype == np.float64
                                                    else 1e-7) * scale)
    # the JAX engine (f32 only, in tap-slot order): the same entries, bit for
    # bit; the port's f64 values round to its f32 ones
    ref = jmax.maxwell_ell_operator(*grid)
    dense_jax = _dense(np.asarray(ref.data, np.float64), np.asarray(ref.indices), n)
    dense_f32 = _dense(got.data.numpy().astype(np.float32).astype(np.float64),
                       got.indices.numpy(), n)
    np.testing.assert_array_equal(dense_f32, dense_jax)


def test_maxwell_ell_spmv_matches_jax():
    a = tmax.maxwell_ell_operator(3, 3, 3, **CPU)
    x = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)
    got = a.mv(torch.from_numpy(x)).numpy()
    want = np.asarray(jmax.maxwell_ell_operator(3, 3, 3).mv(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def _halo_case():
    """A symmetric band of half-width 40 on 1001 rows with f64 values that
    round in f32: on 4 shards rows_loc = 256 (pad rows 1001..1023) and the
    halo is 40."""
    rng = np.random.default_rng(9)
    offs = [0, 1, -1, 17, -17, 40, -40]
    a = sp.diags([rng.standard_normal(1001 - abs(o)) for o in offs], offs,
                 format="csr")
    return (a + a.T).tocsr()


@pytest.mark.parametrize("dtype", DTYPES)
def test_halo_ell_bit_equal_to_numpy_and_jax(dtype, monkeypatch):
    """The engine's halo ELL, shard by shard and across shard boundaries,
    equals the NumPy version (`packer="numpy"`) bit for bit, and in f32
    the JAX engine's and the JAX NumPy loop's global arrays."""
    from lanczos_tpu import native as jax_native
    from lanczos_tpu.parallel import halo_sharded_ell, make_mesh
    from lanczos_tpu_torch.parallel import dist_operator as D

    a, k = _halo_case(), 4
    shards = {p: [D.halo_shard(a, k, r, dtype, "none", p) for r in range(k)]
              for p in ("native", "numpy")}
    halo, rows = shards["native"][0][2], shards["native"][0][3]
    assert (halo, rows) == (40, 256)
    full = {p: [np.concatenate([s[i] for s in shards[p]]) for i in (0, 1)]
            for p in shards}
    for g, p in zip(full["native"], full["numpy"]):
        assert g.dtype == p.dtype and g.shape == (k * rows, 7)
        np.testing.assert_array_equal(g, p)
    data, idx = full["native"]
    assert not data[1001:].any() and (idx[1001:] == halo).all()
    # a window of rows across the boundary of shards 1 and 2
    part = native.halo_ell_from_csr(a.indptr, a.indices, a.data, 1001, 7, rows,
                                    halo, dtype, row0=2 * rows - 3, rows_out=6)
    np.testing.assert_array_equal(part[0], data[2 * rows - 3 : 2 * rows + 3])
    np.testing.assert_array_equal(part[1], idx[2 * rows - 3 : 2 * rows + 3])
    if dtype != np.float32:
        return
    engine = jax_native.halo_ell_from_csr(a.indptr, a.indices, a.data, 1001,
                                          k * rows, 7, rows, halo)
    assert engine is not None, "the JAX engine did not build"
    np.testing.assert_array_equal(data, engine[0])
    np.testing.assert_array_equal(idx, engine[1])
    monkeypatch.setattr(jax_native, "halo_ell_from_csr", lambda *args: None)
    loop = halo_sharded_ell(a, make_mesh(k), dtype=jnp.float32, reorder="none")
    np.testing.assert_array_equal(data, np.asarray(loop.data))
    np.testing.assert_array_equal(idx, np.asarray(loop.indices))


def test_native_rejects_other_dtypes_and_bad_csr():
    a = laplacian_2d_scipy(4, 4).tocsr()
    with pytest.raises(TypeError, match="float32 or float64"):
        native.ell_from_csr(a.indptr, a.indices, a.data, 16, 5, np.float16)
    with pytest.raises(ValueError, match="indptr"):
        native.window_pack_count(a.indptr[:-1], a.indices, 16)
    with pytest.raises(ValueError, match="packer"):
        tfmt.ell_from_scipy(a, packer="scipy", **CPU)
    with pytest.raises(ValueError, match="row0=-1"):
        native.halo_ell_from_csr(a.indptr, a.indices, a.data, 16, 5, 8, 4,
                                 np.float32, row0=-1)


_BUILD = (
    "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
    "import numpy as np; from lanczos_tpu_torch import native;"
    "native.BUILD_DIR = Path(sys.argv[2]); native.library();"
    "print(native.window_pack_count(np.array([0, 1]), np.array([0]), 1))"
)


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, REPO, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["1", "1"]
    libs = sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".so")
    assert len(libs) == 1 and libs[0].startswith("liblanczos_native-"), libs
    # a third process loads the library the first two left
    out = subprocess.run([sys.executable, "-c", _BUILD, REPO, str(tmp_path)],
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "1"


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
    assert not any((tmp_path / "build").glob("*.so"))
