"""The port's matrix IO (lanczos_tpu_torch/io.py) against the JAX
package's (lanczos_tpu/io.py): the same files load to the same matrices,
every format builds an operator that agrees with JAX's (f64 to 1e-12 of
scale, f32 to 2e-6), and `auto_operator` picks the same class (DIA /
windowed / gathered ELL), warning where it falls back."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.io import mmwrite

from lanczos_tpu import io as jio
from lanczos_tpu_torch import io as tio
from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy

CPU = dict(device="cpu")


def _random_sym(n, rng, density=0.05):
    a = sp.random(n, n, density=density, random_state=np.random.RandomState(
        int(rng.integers(1 << 30))))
    return (a + a.T + sp.identity(n) * 4.0).tocsr()


@pytest.mark.parametrize("kind", ["mtx", "mtx_symmetric", "mtx.gz", "npz"])
def test_load_sparse_matches_jax(kind, tmp_path, rng):
    a = _random_sym(60, rng)
    if kind == "npz":
        path = tmp_path / "a.npz"
        sp.save_npz(path, a)
    else:
        path = tmp_path / "a.mtx"
        mmwrite(str(path), a, symmetry="symmetric" if "symmetric" in kind else None)
        if kind == "mtx.gz":
            import gzip

            gz = tmp_path / "a.mtx.gz"
            gz.write_bytes(gzip.compress(path.read_bytes()))
            path = gz
    got, want = tio.load_sparse(str(path)), jio.load_sparse(str(path))
    assert sp.isspmatrix_csr(got) or isinstance(got, sp.csr_array)
    assert abs(got - want).max() == 0 and abs(got - a).max() < 1e-12
    with pytest.raises(ValueError, match="unknown sparse matrix format"):
        tio.load_sparse(str(tmp_path / "a.txt"))


# windowed in f64 is held to scipy in test_torch_window_ell.py: JAX's
# windowed kernel sums f64 states in f32
@pytest.mark.parametrize("fmt,dtype", [
    (f, d) for f in ("ell", "csr", "coo", "bsr", "dia", "windowed")
    for d in ("float32", "float64") if (f, d) != ("windowed", "float64")
])
def test_operator_from_file_matches_jax(fmt, dtype, tmp_path, rng):
    a = laplacian_2d_scipy(12) + sp.diags(rng.random(144))
    path = str(tmp_path / "a.mtx")
    mmwrite(path, a)
    jop = jio.operator_from_file(path, format=fmt, dtype=jnp.dtype(dtype))
    top = tio.operator_from_file(path, format=fmt, dtype=getattr(torch, dtype), **CPU)
    assert type(top).__name__ == type(jop).__name__
    assert top.dtype == getattr(torch, dtype)
    X = rng.standard_normal((3, 144)).astype(dtype)
    want = np.asarray(jop.mm(jnp.asarray(X)))
    got = top.mm(torch.from_numpy(X)).numpy()
    tol = 1e-12 if dtype == "float64" else 2e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_operator_from_file_defaults(tmp_path, rng):
    a = _random_sym(50, rng)
    path = str(tmp_path / "a.npz")
    sp.save_npz(path, a)
    op = tio.operator_from_file(path, **CPU)
    assert type(op).__name__ == "EllMatrix" and op.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown format"):
        tio.operator_from_file(path, format="hyb", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tio.operator_from_file(path)


def test_mesh_is_not_ported(tmp_path, rng):
    """With a mesh, "windowed" and "auto" (whose first choice JAX's is)
    build this rank's HaloShardedWindowed, the shard `windowed_shard`
    gives, on the mesh's device; so does auto_operator, whose class is
    JAX's on make_mesh(k)."""
    from lanczos_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lanczos_tpu_torch.parallel import dist_windowed as W
    from lanczos_tpu_torch.parallel.mesh import Mesh

    # few diagonals: DIA without a mesh, the windowed operator with one
    a = laplacian_2d_scipy(20, 15).tocsr()
    path = str(tmp_path / "a.npz")
    sp.save_npz(path, a)
    for k in (1, 2):
        want = type(jio.auto_operator(a, mesh=jax_make_mesh(k))).__name__
        assert want == "HaloShardedWindowed"
        for rank in range(k):
            mesh = Mesh(rank, k, torch.device("cpu"), None)
            arrays, *_ = W.windowed_shard(a, k, rank, np.float64)
            ops = [tio.operator_from_file(path, format=f, mesh=mesh, dtype=torch.float64)
                   for f in ("windowed", "auto")]
            ops.append(tio.auto_operator(a, mesh=mesh, dtype=torch.float64))
            for op in ops:
                assert type(op).__name__ == want and op.mesh is mesh
                assert op.local.planes_data.device.type == "cpu"
                np.testing.assert_array_equal(op.local.planes_data.numpy(), arrays[0])


@pytest.mark.parametrize("k", [1, 2])
def test_operator_from_file_with_a_mesh(k, tmp_path, rng):
    """format "halo"/"ell" builds this rank's HaloShardedEll and "gather"
    its GatherShardedEll, the shards `dist_operator`'s builders give, on
    the mesh's device; another format is a ValueError."""
    from lanczos_tpu_torch.parallel import dist_operator as D
    from lanczos_tpu_torch.parallel.mesh import Mesh

    a = laplacian_2d_scipy(9, 8)
    path = str(tmp_path / "a.mtx")
    mmwrite(path, a)
    for rank in range(k):
        mesh = Mesh(rank, k, torch.device("cpu"), None)
        for fmt in ("halo", "ell", "gather"):
            op = tio.operator_from_file(path, format=fmt, mesh=mesh,
                                        dtype=torch.float64)
            if fmt == "gather":
                assert type(op) is D.GatherShardedEll
                data, idx, _ = D.gather_shard(a, k, rank, np.float64)
            else:
                assert type(op) is D.HaloShardedEll
                data, idx, *_ = D.halo_shard(a, k, rank, np.float64)
            assert op.mesh is mesh and op.data.device.type == "cpu"
            np.testing.assert_array_equal(op.data.numpy(), data)
            np.testing.assert_array_equal(op.indices.numpy(), idx)
        with pytest.raises(ValueError, match="distributed format"):
            tio.operator_from_file(path, format="csr", mesh=mesh)


def _auto_cases(rng):
    n = 2000
    offs = list(range(-20, 21))
    band = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs).tocsr()
    return {
        "few diagonals": laplacian_2d_scipy(20, 20),
        "banded": band,
        # ~50 nonzeros a row over four 256-wide windows: no plan within the
        # 48-plane cap, in either package
        "unplannable": sp.random(1000, 1000, density=0.05, random_state=6,
                                 format="csr"),
    }


@pytest.mark.parametrize("case", ["few diagonals", "banded", "unplannable"])
def test_auto_operator_picks_jax_class(case, rng):
    a = _auto_cases(rng)[case]
    want = type(jio.auto_operator(a)).__name__
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        op = tio.auto_operator(a, **CPU)
    assert type(op).__name__ == want
    fell_back = [w for w in caught if "falling back" in str(w.message)]
    assert len(fell_back) == (want == "EllMatrix")
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    permute = getattr(op, "permute", lambda v: v)
    unpermute = getattr(op, "unpermute", lambda v: v)
    y = unpermute(op.mv(permute(torch.from_numpy(x)))).numpy()[: a.shape[0]]
    ref = a @ x.astype(np.float64)
    assert np.linalg.norm(y - ref) <= 1e-5 * np.linalg.norm(ref)


def test_auto_operator_classes():
    """The three classes are all reached by the cases above."""
    rng = np.random.default_rng(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        names = {type(tio.auto_operator(a, **CPU)).__name__
                 for a in _auto_cases(rng).values()}
    assert names == {"DiaMatrix", "WindowedEllMatrix", "EllMatrix"}
