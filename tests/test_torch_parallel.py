"""The port's z-slab multi-device layer (`lanczos_tpu_torch/parallel/`,
`ops/tsqr.py` `tsqr_sharded`) on k = 1, 2 and 4 gloo ranks on the CPU,
against the JAX package's `DistributedPallasMaxwell` and `tsqr_sharded`
on `make_mesh(k)` of conftest's 8 virtual devices (Pallas in interpret
mode), and against the port's single-device `PallasMaxwellOperator`;
the row-sharded ELL and windowed-ELL operators, io with a mesh, the
checkpoint repairs and the dry run on the same ranks, against scipy and
the JAX package's operators.

The ranks run `tests/torch_parallel_cases.py`, one spawn per world size
for all its scenarios; every spawn has a timeout and fails when it runs
out.  Tolerances: pack and unpack exact; mv/mm f32 to 1e-5 of scale (JAX
and single device), f64 to 1e-12 (single device); Lanczos in f64 to
1e-10 of each array's scale (Maxwell's alphas are zero, so the atol is
scaled to beta_0), in f32 at JAX's own test_dist_stencil.py:52-95
tolerances (1e-3/1e-4 vector, 2e-2/1e-2 block); FDTD like mv/mm;
`tsqr_sharded` at test_tsqr.py:78-130's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczos_tpu.ops.tsqr import tsqr_sharded as jax_tsqr_sharded
from lanczos_tpu.parallel import DistributedPallasMaxwell as JaxDist
from lanczos_tpu.parallel import make_mesh as jax_make_mesh
from lanczos_tpu_torch.config import LanczosConfig
from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.parallel import DistributedPallasMaxwell, launch, make_mesh
from lanczos_tpu_torch.parallel.dist_stencil import slab_rows, slab_weights
from lanczos_tpu_torch.parallel.mesh import Mesh
from tests import torch_parallel_cases as cases

RANKS = (1, 2, 4)
SPAWN_TIMEOUT = 240.0
DTYPES = list(cases.DTYPES)
MM_RTOL = {"float32": 1e-5, "float64": 1e-12}
# (rtol, atol / beta_0) per dtype and kind
LANCZOS_TOL = {("float64", "vector"): (1e-10, 1e-10),
               ("float64", "block"): (1e-10, 1e-10),
               ("float32", "vector"): (1e-3, 1e-4),
               ("float32", "block"): (2e-2, 1e-2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """k -> the k ranks' scenario results, one spawn per k, made once; at
    the repairs' world size the JAX package first writes a checkpoint for
    the ranks to resume."""
    cache = {}

    def get(k):
        if k not in cache:
            tmp = tmp_path_factory.mktemp(f"ranks{k}")
            if k == cases.REPAIR_RANKS:
                for key, jop in (("halo", _jax_ell(k, "laplacian", "halo")),
                                 ("windowed", _jax_windowed(k, "lap40", jnp.float64))):
                    _jax_checkpoint(str(tmp / cases.JAX_CK_FILES[key]), jop)
            cache[k] = launch.run(cases.scenarios, k, str(tmp), device="cpu",
                                  timeout=SPAWN_TIMEOUT)
        return cache[k]

    return get


@pytest.fixture(scope="module")
def single():
    """dtype name -> the single-device operator and its packed inputs."""
    cache = {}

    def get(name):
        if name not in cache:
            dtype = cases.DTYPES[name]
            op = PallasMaxwellOperator.create(*cases.GRID, dtype=dtype, device="cpu")
            b, B = cases.start(op.n, dtype)
            cache[name] = op, op.pack(b), op.pack(B)
        return cache[name]

    return get


def _jax_op(k, dtype=jnp.float32):
    return JaxDist.create(*cases.GRID, jax_make_mesh(k), dtype=dtype)


def _glued(results, key, name="float32"):
    """The ranks' slabs of one state joined along z: JAX's global state."""
    return torch.cat([r[name][key] for r in results], dim=-2).numpy()


def _dist_op(k, rank=0, dtype=torch.float64, tz=8):
    """Rank `rank`'s operator of a k-rank mesh, built in this process with
    no process group: its unpack_slabs, state_index and trace_fn call no
    collective."""
    mesh = Mesh(rank, k, torch.device("cpu"), None)
    specs, wz, wp, zl = slab_weights(*cases.GRID, k, rank, tz,
                                     np.dtype(str(dtype)[6:]))
    return DistributedPallasMaxwell(*cases.GRID, torch.from_numpy(wz),
                                    torch.from_numpy(wp), specs, mesh, zl, tz)


def _slabs(results, key, name):
    return torch.stack([r[name][key] for r in results])


def _assert_scaled(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


# -- geometry and packing ---------------------------------------------------


@pytest.mark.parametrize("k", RANKS)
def test_slab_layout_matches_jax(k):
    jop = _jax_op(k)
    zl, zs = slab_rows(cases.GRID[2], k)
    assert (zl, zs) == (jop.zl, jop.spec_e.zc)
    jwz = np.asarray(jop.wz_t)  # (k, 2, Zs, T)
    for rank in range(k):
        specs, wz, wp, zl_r = slab_weights(*cases.GRID, k, rank)
        assert zl_r == zl and specs[0].taps == jop.spec_e.taps
        assert specs[1].taps == jop.spec_h.taps and specs[0].zc == zs
        np.testing.assert_array_equal(wz, jwz[rank])
        np.testing.assert_array_equal(wp, np.asarray(jop.wplane_s))


@pytest.mark.parametrize("k", RANKS)
def test_pack_matches_jax_pack1_index_for_index(k, ranks):
    res = ranks(k)
    jop = _jax_op(k)
    b, B = cases.start(jop.n, torch.float32)
    np.testing.assert_array_equal(_glued(res, "pack1"), jop._pack1(b.numpy()))
    np.testing.assert_array_equal(_glued(res, "pack"), np.asarray(jop.pack(B.numpy())))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_pack_unpack_round_trip(k, name, ranks):
    res = ranks(k)
    _, B = cases.start(_dist_op(k).n, cases.DTYPES[name])
    for r in res:  # unpack gathers: every rank has the whole vector
        torch.testing.assert_close(r[name]["roundtrip"], B, rtol=0, atol=0)
    op = _dist_op(k, dtype=cases.DTYPES[name])
    torch.testing.assert_close(op.unpack_slabs(_slabs(res, "pack", name)), B,
                               rtol=0, atol=0)


@pytest.mark.parametrize("k", RANKS)
def test_state_index_and_trace_owner_match_jax(k):
    jop = _jax_op(k)
    for lc in (0, cases.LC, jop.n - 1):
        c, z, ps = _dist_op(k).state_index(lc)
        assert (c, z, ps) == tuple(int(v) for v in jop.state_index(lc))
        zs, plane = jop.spec_e.zc, jop.spec_e.plane
        owners = [_dist_op(k, rank).trace_fn(lc)(torch.ones(2, 6, zs, plane))
                  for rank in range(k)]
        assert [bool(o.any()) for o in owners] == [r == z // jop.spec_e.zc
                                                   for r in range(k)]


# -- products ---------------------------------------------------------------


@pytest.mark.parametrize("k", RANKS)
def test_mv_mm_match_jax_distributed(k, ranks):
    res = ranks(k)
    jop = _jax_op(k)
    b, B = cases.start(jop.n, torch.float32)
    want_mv = np.asarray(jax.jit(lambda o, u: o.mv(u))(jop, jop.pack(b.numpy())))
    want_mm = np.asarray(jax.jit(lambda o, u: o.mm(u))(jop, jop.pack(B.numpy())))
    _assert_scaled(_glued(res, "mv"), want_mv, 1e-5)
    _assert_scaled(_glued(res, "mm"), want_mm, 1e-5)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_mv_mm_match_single_device(k, name, ranks, single):
    res = ranks(k)
    op, u, U = single(name)
    dop = _dist_op(k, dtype=cases.DTYPES[name])
    _assert_scaled(dop.unpack_slabs(_slabs(res, "mv", name)), op.unpack(op.mv(u)),
                   MM_RTOL[name])
    _assert_scaled(dop.unpack_slabs(_slabs(res, "mm", name)), op.unpack(op.mm(U)),
                   MM_RTOL[name])


@pytest.mark.parametrize("k", RANKS)
def test_two_row_pads_match_single_device(k, ranks, single):
    """tz = 2: the halo rows sit next to the other rank's data (JAX takes
    only multiples of 8)."""
    res = ranks(k)
    op, _, U = single("float64")
    dop = _dist_op(k, tz=2)
    got = dop.unpack_slabs(torch.stack([r["tz2_mm"] for r in res]))
    _assert_scaled(got, op.unpack(op.mm(U)), MM_RTOL["float64"])


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_pad_rows_stay_exactly_zero(k, name, ranks):
    """After mv, mm and 10 FDTD steps every row outside a slab's interior,
    and every interior row past the grid, is exactly zero."""
    res = ranks(k)
    zl, zs = slab_rows(cases.GRID[2], k)
    tz = (zs - zl) // 2
    for rank, r in enumerate(res):
        pad = torch.ones(zs, dtype=torch.bool)
        first = rank * zl
        pad[tz : tz + zl] = False
        past = max(0, first + zl - (cases.GRID[2] + 1))  # rows beyond z_ext
        if past:
            pad[tz + zl - past : tz + zl] = True
        for key in ("pack", "mv", "mm", "fdtd", "fdtd_vector"):
            slab = r[name][key]
            assert not slab[..., pad, :].any(), (rank, key)


# -- Lanczos ------------------------------------------------------------------


@pytest.mark.parametrize("case", cases.LANCZOS_CASES,
                         ids=lambda c: "-".join(filter(None, c)))
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_lanczos_matches_single_device(k, name, case, ranks, single):
    res = ranks(k)
    op, u, U = single(name)
    want = cases.lanczos(op, *case, u, U, op.trace_fn(cases.LC))
    rtol, atol = LANCZOS_TOL[name, case[0]]
    scale = float(want[1].reshape(want[1].shape[0], -1)[0].abs().max())  # beta_0
    for r in res:
        got = r[name]["lanczos"][case]
        for g, w, what in zip(got, want, ("alphas", "betas", "trace", "beta_final")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                       atol=atol * scale, err_msg=what)
    for r in res[1:]:  # every rank holds the same replicated coefficients
        for g, w in zip(r[name]["lanczos"][case], res[0][name]["lanczos"][case]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_expm_action_same_on_every_rank(k, name, ranks, single):
    res = ranks(k)
    op, _, U = single(name)
    want = block_lanczos_expm_action(op, U, cases.M, 1.0, 0,
                                     trace_fn=op.trace_fn(cases.LC))
    rtol = LANCZOS_TOL[name, "block"][0]
    for r in res:
        torch.testing.assert_close(r[name]["expm"], res[0][name]["expm"],
                                   rtol=0, atol=0)
        _assert_scaled(r[name]["expm"], want, rtol)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("k", RANKS)
def test_fdtd_matches_single_device(k, name, ranks, single):
    """10 steps of u + (dt A) u: K1 plus an add on the slabs, K5's plain
    version on the single-device state."""
    res = ranks(k)
    op, u, U = single(name)
    dop = _dist_op(k, dtype=cases.DTYPES[name])
    _assert_scaled(dop.unpack_slabs(_slabs(res, "fdtd", name)),
                   op.unpack(fdtd_block(op, U, cases.FDTD_STEPS, 1.0)),
                   MM_RTOL[name])
    _assert_scaled(dop.unpack_slabs(_slabs(res, "fdtd_vector", name)),
                   op.unpack(fdtd_vector(op, u, cases.FDTD_STEPS, 1.0)),
                   MM_RTOL[name])


def test_distributed_operator_takes_the_add_step_not_k5():
    """The distributed operator has no fdtd_step: K5's identity term would
    copy the halo planes into the pads (euler_steps takes JAX's branch)."""
    assert hasattr(DistributedPallasMaxwell, "scaled")
    assert not hasattr(DistributedPallasMaxwell, "fdtd_step")


# -- the fused gates ------------------------------------------------------------


@pytest.mark.parametrize("k", RANKS)
def test_fused_routes_refuse_a_distributed_operator(k, ranks):
    refusals = ranks(k)[0]["refusals"]
    assert "non-distributed operator" in refusals["block fused=True"]
    assert refusals["block fused=True"].startswith("fused=True requires")
    assert "non-distributed operator" in refusals["block compensated=True"]
    assert refusals["block compensated=True"].startswith("compensated=True")
    assert "non-distributed operator" in refusals["vector fused=True"]


@pytest.mark.parametrize("kind", ["vector", "block"])
def test_auto_gate_takes_the_materialized_recurrence(kind, ranks):
    """fused=None on f64 states over 16 MB on each of 2 ranks: the fused
    recurrence (patched to raise in the ranks) never runs, and the result
    is the fused=False run's."""
    for r in ranks(cases.GATE_RANKS):
        gate = r["gate"]
        assert gate["state_bytes"] >= 16 * 1024 * 1024
        a, b, a_ref, b_ref = gate[kind]
        torch.testing.assert_close(a, a_ref, rtol=0, atol=0)
        torch.testing.assert_close(b, b_ref, rtol=0, atol=0)


# -- tsqr_sharded --------------------------------------------------------------


@pytest.mark.parametrize("case", list(cases.TSQR_CASES))
@pytest.mark.parametrize("k", RANKS)
def test_tsqr_sharded_matches_jax(k, case, ranks):
    x = cases.tsqr_input(case)
    qj, rj = jax_tsqr_sharded(jnp.asarray(x), jax_make_mesh(k))
    qj, rj = np.asarray(qj), np.asarray(rj)
    parts = [r["tsqr"][case] for r in ranks(k)]
    q = torch.cat([qp for qp, _ in parts], dim=1).numpy()
    for _, r in parts:  # one R on every rank
        torch.testing.assert_close(r, parts[0][1], rtol=0, atol=0)
    r = parts[0][1].numpy()
    np.testing.assert_allclose(r, rj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(q, qj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(q @ q.T, np.eye(x.shape[0]), atol=1e-4)
    np.testing.assert_allclose(r.T @ q, x, rtol=1e-3, atol=1e-3)
    assert np.all(np.diag(r) >= 0) and np.allclose(r, np.triu(r), atol=1e-6)
    if case == "zero_pad_rows":
        assert np.abs(q[:, 500:700]).max() < 1e-5


# -- the CLI ----------------------------------------------------------------------


def test_cli_devices_2_matches_devices_1():
    """--device cpu --operator pallas -N 4 -m 6 --devices 2 against
    --devices 1: the same solution in f64 to 1e-10, the same oracle."""
    from lanczos_tpu_torch.cli import run

    kw = dict(n_grid=4, m=6, operator="pallas", dtype="float64",
              fdtd_steps=2000, device="cpu")
    one = run(LanczosConfig(**kw))
    two = run(LanczosConfig(devices=2, **kw))
    assert set(two) == set(one) and two["n"] == one["n"] and two["lc"] == one["lc"]
    np.testing.assert_allclose(two["solution"], one["solution"], rtol=1e-10)
    assert two["relative_error"] < 1e-3
    np.testing.assert_allclose(two["relative_error"], one["relative_error"],
                               rtol=1e-6)


# -- mesh and launch ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_mesh_collectives(k):
    got = launch.run(cases.describe, k, device="cpu", timeout=SPAWN_TIMEOUT)
    total = sum(range(1, k + 1))
    for rank, r in enumerate(got):
        assert (r["rank"], r["size"], r["device"]) == (rank, k, "cpu")
        assert r["gather"].tolist() == [[float(i)] for i in range(k)]
        assert r["sum"].tolist() == [total, total]
        assert r["any"] is True and r["none"] is False
        left = 10.0 * (rank - 1) + 1 if rank > 0 else 0.0
        right = 10.0 * (rank + 1) if rank < k - 1 else 0.0
        assert r["from_left"].tolist() == [left] * 3
        assert r["from_right"].tolist() == [right] * 3
        # halo_window: rank r's rows of the global (2, 4k) state with h
        # columns each side, zeros past the ends (k-hop for h > 4)
        rows = cases.WINDOW_ROWS
        glob = torch.cat([torch.arange(rows, dtype=torch.float64) + 10.0 * i + 1
                          for i in range(k)])
        for h in cases.WINDOW_HALOS:
            padded = torch.cat([torch.zeros(h, dtype=torch.float64), glob,
                                torch.zeros(h, dtype=torch.float64)])
            want = padded[rank * rows : rank * rows + rows + 2 * h]
            torch.testing.assert_close(r["windows"][h], torch.stack([want, -want]),
                                       rtol=0, atol=0)


def test_a_rank_exception_is_raised_in_the_parent():
    with pytest.raises(KeyError, match="on purpose") as info:
        launch.run(cases.raise_on, 2, 1, KeyError, device="cpu",
                   timeout=SPAWN_TIMEOUT)
    assert any("rank 1 of 2" in note for note in info.value.__notes__)


def test_a_rank_that_dies_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 0 of 1 exited with code 3"):
        launch.run(cases.exit_on, 1, 0, device="cpu", timeout=SPAWN_TIMEOUT)


def test_a_run_past_its_timeout_is_stopped():
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        launch.run(cases.sleep, 1, 600, device="cpu", timeout=5)


def test_more_cards_than_the_machine_has_is_a_value_error():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {have} available"):
        launch.run(cases.describe, have + 1, device="cuda", timeout=SPAWN_TIMEOUT)
    with pytest.raises(ValueError, match="at least 1"):
        launch.run(cases.describe, 0, device="cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="launch.run"):
        make_mesh(1, device="cpu")


def test_rank_functions_import_no_jax(tmp_path):
    """The ranks import the port and tests/torch_parallel_cases.py only;
    the row-sharded ELL and windowed operators, io with a mesh, the dry
    run and the native packers run without pulling in jax either."""
    import subprocess
    import sys

    import scipy.sparse as sp

    path = str(tmp_path / "a.npz")
    sp.save_npz(path, cases.laplacian_2d_scipy(6, 5).tocsr())
    code = ("import sys; import tests.torch_parallel_cases; "
            "import lanczos_tpu_torch.parallel.launch; "
            "import torch; import lanczos_tpu_torch.parallel.dist_operator as D; "
            "from lanczos_tpu_torch.io import operator_from_file; "
            "from lanczos_tpu_torch.parallel.mesh import Mesh; "
            "op = operator_from_file(sys.argv[1], format='halo', "
            "mesh=Mesh(1, 2, torch.device('cpu'), None)); "
            "assert type(op) is D.HaloShardedEll and op.halo == 6; "
            "op = operator_from_file(sys.argv[1], format='windowed', "
            "mesh=Mesh(0, 1, torch.device('cpu'), None)); "
            "assert type(op).__name__ == 'HaloShardedWindowed'; "
            "import lanczos_tpu_torch.parallel.dryrun; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'lanczos_tpu.')) "
            "for m in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, path], cwd=root, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "False"


# -- the example and the weak-scaling benchmark -------------------------------------


def test_distributed_example_matches_the_single_device_eigsh(tmp_path):
    import json

    from lanczos_tpu_torch.examples import distributed_lanczos as ex
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B

    path = str(tmp_path / "ritz.json")
    out = ex.main(["--device", "cpu", "--devices", "2", "--n-grid", "6",
                   "--json", path])
    assert json.load(open(path)) == out and out["devices"] == 2
    op = PallasMaxwellOperator.create(6, 6, 6, device="cpu")
    B = op.pack(torch.from_numpy(gaussian_matrix_B(6, op.n, ex.P).astype(np.float32)))
    vals, _, resid = block_lanczos_eigsh(op, B, ex.M, ex.K, which="LM")
    np.testing.assert_allclose(out["ritz"], vals.numpy(), rtol=1e-4)
    np.testing.assert_allclose(out["resid"], resid.numpy(), rtol=1e-2, atol=1e-6)


def test_weak_scaling_runs_each_mesh_size(tmp_path, monkeypatch):
    import json

    from lanczos_tpu_torch.benchmarks import weak_scaling
    from lanczos_tpu_torch.parallel import mesh as mesh_mod

    path = str(tmp_path / "ws.json")
    rows = weak_scaling.main(["--device", "cpu", "--devices", "1", "2",
                              "--n-xy", "5", "--z-per-device", "8", "--json", path])
    assert json.load(open(path)) == rows
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["efficiency"] == 1.0
    assert all(r["seconds_per_spmm"] > 0 and r["device"] == "cpu" for r in rows)
    # a machine with one card: d = 2 is skipped, never run on one card
    monkeypatch.setattr(mesh_mod, "available_devices", lambda device_type: 1)
    assert weak_scaling.main(["--devices", "2"]) == []


def test_slope_time_on_a_mesh_takes_one_chain_length():
    """Two gloo ranks time a chain that all-reduces; only rank 1's clock
    asks for a longer chain.  With the mesh's group every rank escalates
    together (both try k2 = 12, then 96), so neither waits in the chain
    for a rank that stopped: the run ends well inside its timeout."""
    tried = launch.run(cases.disagreeing_escalation, 2, device="cpu", timeout=60)
    assert tried == [[12, 96], [12, 96]]


@pytest.mark.parametrize("k", RANKS)
def test_storage_trace_reads_jax_global_flat_index(k, ranks):
    """The Lanczos methods' receiver when given lc and no trace_fn: flat
    index i of JAX's global stacked state, read on its rank and zero
    elsewhere."""
    res = ranks(k)
    glued = _glued(res, "pack1")
    rng = np.random.default_rng(k)
    nonzero = np.flatnonzero(glued)
    for i in (*rng.choice(nonzero, 4), 0):
        parts = [_dist_op(k, rank, torch.float32).storage_trace_fn(int(i))(
            r["float32"]["pack1"]) for rank, r in enumerate(res)]
        assert sum(float(v) for v in parts) == glued.reshape(-1)[i]
        assert sum(bool(v != 0) for v in parts) <= 1


# -- the row-sharded ELL operators on the ranks ---------------------------------
# (the rank side of tests/test_torch_dist_ell.py, which holds the in-process
# tests: the shards run in this file's one spawn per world size)

ELL_RTOL = {"float32": 1e-6, "float64": 1e-12}
ELL_LANCZOS_RTOL = 1e-10  # of each array's scale, f64, against JAX
JAX_DTYPES = {"float32": jnp.float32, "float64": jnp.float64}


def _ell_local(k, rank, name, builder, dtype=torch.float64):
    """Rank `rank`'s operator of a k-rank mesh, built here with no process
    group (its pad_vector, unpad_shards and traces call no collective)."""
    from lanczos_tpu_torch.parallel import dist_operator as D

    mesh = Mesh(rank, k, torch.device("cpu"), None)
    a, reorder = cases.ell_matrices()[name]
    if builder == "halo":
        return D.halo_sharded_ell(a, mesh, dtype=dtype, reorder=reorder)
    return D.gather_sharded_ell(a, mesh, dtype=dtype)


def _jax_ell(k, name, builder, dtype=jnp.float64, a=None):
    from lanczos_tpu.parallel import gather_sharded_ell as jg
    from lanczos_tpu.parallel import halo_sharded_ell as jh

    mat, reorder = cases.ell_matrices()[name] if a is None else (a, "auto")
    if builder == "halo":
        return jh(mat, jax_make_mesh(k), dtype=dtype, reorder=reorder)
    return jg(mat, jax_make_mesh(k), dtype=dtype)


def _jax_checkpoint(path, jop):
    """A JAX checkpointed block run on jop (the 2-device mesh's halo ELL or
    windowed operator), stopped at j = JAX_CK_STOPPED and grown to m =
    JAX_CK_M."""
    from lanczos_tpu.methods import checkpoint as jax_ck

    B = _start_block(jop)
    jax_ck.block_lanczos_checkpointed(
        jop, jop.pad_vector(B.numpy()), cases.JAX_CK_STOPPED,
        jop.local_index(cases.ELL_LC), chunk=cases.CK_CHUNK, path=path)
    c = jax_ck.BlockLanczosCheckpoint.load(path)
    for name in ("alphas", "betas", "trace"):
        arr = getattr(c, name)
        big = np.zeros((cases.JAX_CK_M,) + arr.shape[1:], arr.dtype)
        big[: arr.shape[0]] = arr
        setattr(c, name, big)
    c.m = cases.JAX_CK_M
    c.save(path)


def _start_block(jop):
    """The ranks' start block of the operator's family (ell or windowed)."""
    start = cases.windowed_start if "Windowed" in type(jop).__name__ else cases.ell_start
    return start(jop.n_rows_true, torch.float64)[1]


def _jax_windowed(k, name, dtype=jnp.float32):
    from lanczos_tpu.parallel.dist_windowed import halo_sharded_windowed as jw

    a, reorder = cases.windowed_matrices()[name]
    return jw(a, jax_make_mesh(k), dtype=dtype, reorder=reorder, cpb=2, spg=2)


def _stitched(res, k, name, builder, dname, key):
    shards = torch.stack([r["ell"]["products"][name, builder, dname][key]
                          for r in res])
    op = _ell_local(k, 0, name, builder, cases.DTYPES[dname])
    return shards, op.unpad_shards(shards)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("builder", list(cases.ELL_BUILDERS))
@pytest.mark.parametrize("name", list(cases.ell_matrices()))
@pytest.mark.parametrize("k", RANKS)
def test_ell_products_match_scipy_and_jax(k, name, builder, dname, ranks):
    """mv and mm on the k ranks, stitched, against scipy's product (f64 to
    1e-12 of scale, f32 to 1e-6) and the JAX operator's on make_mesh(k)."""
    res = ranks(k)
    a = cases.ell_matrices()[name][0]
    b, B = cases.ell_start(a.shape[0], torch.float64)
    jop = _jax_ell(k, name, builder, JAX_DTYPES[dname])
    for key, x in (("mv", b), ("mm", B)):
        _, got = _stitched(res, k, name, builder, dname, key)
        _assert_scaled(got, (a @ x.numpy().T).T, ELL_RTOL[dname])
        y = (jop.mv if key == "mv" else jop.mm)(jop.pad_vector(x.numpy()))
        want = np.asarray(y)[..., : a.shape[0]]
        if getattr(jop, "perm", None) is not None:
            want = np.asarray(jop.unpad_vector(y))
        _assert_scaled(got, want, ELL_RTOL[dname])


@pytest.mark.parametrize("k", RANKS)
def test_ell_pad_rows_stay_exactly_zero(k, ranks):
    """The last rank's rows past n are zero after every product."""
    res = ranks(k)
    for (name, builder, dname), r in res[-1]["ell"]["products"].items():
        n = cases.ell_matrices()[name][0].shape[0]
        past = k * r["rows_loc"] - n
        for key in ("mv", "mm"):
            tail = r[key][..., r["rows_loc"] - past :]
            assert past >= 0 and not tail.any(), (name, builder, dname, key)


@pytest.mark.parametrize("k", RANKS)
def test_ell_unpad_vector_round_trips_on_every_rank(k, ranks):
    for r in ranks(k):
        for (name, _, dname), got in r["ell"]["products"].items():
            b, B = cases.ell_start(cases.ell_matrices()[name][0].shape[0],
                                   cases.DTYPES[dname])
            torch.testing.assert_close(got["roundtrip"], B, rtol=0, atol=0)
            torch.testing.assert_close(got["roundtrip1"], b, rtol=0, atol=0)


def test_ell_multihop_exchange_at_four_ranks(ranks):
    """The arrow matrix on 4 ranks needs a halo of 3 shards: the k-hop
    exchange ran (its products are checked above)."""
    r = ranks(4)[0]["ell"]["products"]["arrow", "halo", "float64"]
    assert -(-r["halo"] // r["rows_loc"]) >= 2
    for k in (1, 2):
        r = ranks(k)[0]["ell"]["products"]["arrow", "halo", "float64"]
        assert r["halo"] <= r["rows_loc"]


@pytest.mark.parametrize("kind", ["vector", "block"])
@pytest.mark.parametrize("builder", list(cases.ELL_BUILDERS))
@pytest.mark.parametrize("name", cases.ELL_LANCZOS)
@pytest.mark.parametrize("k", RANKS)
def test_ell_lanczos_matches_jax(k, name, builder, kind, ranks):
    """Vector (m=8) and block (p=3, m=4) Lanczos in f64 on the k ranks
    against the JAX package's on the same operator on make_mesh(k), to
    1e-10 of each array's scale; the receiver is local_index(lc)."""
    from lanczos_tpu.methods.block_lanczos import block_lanczos as jax_block
    from lanczos_tpu.methods.vector_lanczos import vector_lanczos as jax_vector

    res = ranks(k)
    jop = _jax_ell(k, name, builder)
    b, B = cases.ell_start(jop.n_rows_true, torch.float64)
    lc = jop.local_index(cases.ELL_LC) if builder == "halo" else cases.ELL_LC
    if kind == "vector":
        w = jax_vector(jop, jop.pad_vector(b.numpy()), cases.ELL_M, lc)
    else:
        w = jax_block(jop, jop.pad_vector(B.numpy()), cases.ELL_M // 2, lc)
    want = (w.alphas, w.betas, w.trace, w.beta_final)
    for r in res:
        got = r["ell"]["lanczos"][name, builder][kind]
        for g, x, what in zip(got, want, ("alphas", "betas", "trace", "beta_final")):
            x = np.asarray(x)
            np.testing.assert_allclose(
                g.numpy(), x, rtol=0, err_msg=what,
                atol=ELL_LANCZOS_RTOL * max(np.abs(x).max(), 1e-300))


@pytest.mark.parametrize("builder", list(cases.ELL_BUILDERS))
@pytest.mark.parametrize("k", RANKS)
def test_ell_eigsh_matches_scipy(k, builder, ranks):
    """lanczos_eigsh (m=110, reorth full) top 4 on the 16 x 15 Laplacian,
    to scipy's eigsh at rtol 1e-9 (tests/test_parallel.py:125-133), the
    same on every rank."""
    from scipy.sparse.linalg import eigsh

    a = cases.laplacian_2d_scipy(*cases.EIGSH_GRID)
    want = eigsh(a, k=cases.EIGSH_K, which="LA", return_eigenvectors=False)[::-1]
    res = ranks(k)
    for r in res:
        np.testing.assert_allclose(r["ell"]["eigsh"][builder].numpy(), want, rtol=1e-9)
        torch.testing.assert_close(r["ell"]["eigsh"][builder],
                                   res[0]["ell"]["eigsh"][builder], rtol=0, atol=0)


@pytest.mark.parametrize("k", RANKS)
def test_ell_expm_action_at_receivers_on_every_shard(k, ranks):
    """lanczos_expm_action (m=10, t=1) on the Maxwell halo ELL at
    receivers on the first, a middle and the last shard, to 1e-7 of
    scipy's expm (tests/test_parallel.py:136-149)."""
    from scipy.linalg import expm

    a = cases.ell_matrices()["maxwell"][0]
    b, _ = cases.ell_start(a.shape[0], torch.float64)
    exact = expm(cases.EXPM_T * a.toarray()) @ b.numpy()
    op = _ell_local(k, 0, "maxwell", "halo")
    lcs = cases.expm_receivers(op)
    assert {op.local_index(lc) // op.rows_loc for lc in lcs} == {0, k // 2, k - 1}
    for r in ranks(k):
        assert sorted(r["ell"]["expm"]) == sorted(lcs)
        for lc, sol in r["ell"]["expm"].items():
            assert abs(float(sol) - exact[lc]) / abs(exact[lc]) < 1e-7


# -- the repairs: checkpoints and Ritz residuals on a distributed operator --------

CK_OPS = ("zslab", "halo", "windowed")


@pytest.mark.parametrize("kind", ["vector", "block", "fdtd"])
@pytest.mark.parametrize("op_name", CK_OPS)
def test_checkpointed_run_resumes_on_two_ranks(op_name, kind, ranks):
    """vector/block Lanczos and FDTD, checkpointed on 2 ranks, stopped after
    the first chunk and resumed, equal the monolithic distributed run
    (fused=False; fdtd_block) to 1e-12 of scale, in one file."""
    for r in ranks(cases.REPAIR_RANKS):
        got = r["repairs"][op_name, kind]
        assert got["files"] == ["ck.npz"]
        first = cases.CK_CHUNK if kind == "fdtd" else 1 + cases.CK_CHUNK
        assert got["stopped_at"] == first
        pairs = [(got["got"], got["want"])] if kind == "fdtd" else zip(got["got"],
                                                                      got["want"])
        for g, w in pairs:
            _assert_scaled(g, w, 1e-12)


@pytest.mark.parametrize("op_name", CK_OPS)
def test_ritz_residuals_global_on_two_ranks(op_name, ranks):
    """ritz_residuals on 2 ranks: the same on both, and equal to the
    single-device operator's on the gathered Ritz vectors."""
    from lanczos_tpu_torch.methods.eigs import ritz_residuals
    from lanczos_tpu_torch.models.maxwell import MaxwellOperator
    from lanczos_tpu_torch.ops.formats import ell_from_scipy

    res = [r["repairs"][op_name, "ritz"] for r in ranks(cases.REPAIR_RANKS)]
    for r in res[1:]:
        torch.testing.assert_close(r["resid"], res[0]["resid"], rtol=0, atol=0)
        torch.testing.assert_close(r["vals"], res[0]["vals"], rtol=0, atol=0)
    vals = res[0]["vals"]
    if op_name == "halo":
        a = cases.ell_matrices()["laplacian"][0]
        single = ell_from_scipy(a, dtype=torch.float64, device="cpu")
        vecs = torch.cat([r["vecs"] for r in res])[: a.shape[0]]
    elif op_name == "windowed":
        a = cases.windowed_matrices()["lap40"][0]
        single = ell_from_scipy(a, dtype=torch.float64, device="cpu")
        vecs = _win_local(cases.REPAIR_RANKS, 0, "lap40").unpad_shards(
            torch.stack([r["vecs"].T for r in res])).T
    else:
        single = MaxwellOperator.create(*cases.GRID, dtype=torch.float64, device="cpu")
        dop = _dist_op(cases.REPAIR_RANKS)
        slabs = torch.stack([r["vecs"].T.reshape((-1,) + dop.state_shape)
                             for r in res])
        vecs = dop.unpack_slabs(slabs).T
    want = ritz_residuals(single, vals, vecs)
    assert bool((want > 0).all())
    np.testing.assert_allclose(res[0]["resid"].numpy(), want.numpy(), rtol=1e-10)


def test_jax_written_checkpoint_resumes_on_two_ranks(ranks):
    """A checkpoint the JAX package wrote on its 2-device halo ELL (global
    layout (p, n_pad)) resumes on the port's 2 ranks and finishes equal to
    JAX's uninterrupted run, to 1e-10 of scale."""
    from lanczos_tpu.methods import checkpoint as jax_ck

    jop = _jax_ell(cases.REPAIR_RANKS, "laplacian", "halo")
    _, B = cases.ell_start(jop.n_rows_true, torch.float64)
    want = jax_ck.block_lanczos_checkpointed(
        jop, jop.pad_vector(B.numpy()), cases.JAX_CK_M,
        jop.local_index(cases.ELL_LC))
    for r in ranks(cases.REPAIR_RANKS):
        got = r["repairs"]["jax_resumed", "halo"]
        for g, w in zip(got, (want.alphas, want.betas, want.trace, want.beta_final)):
            _assert_scaled(g, np.asarray(w), 1e-10)


def test_jax_written_windowed_checkpoint_resumes_on_two_ranks(ranks):
    """The same for a checkpoint the JAX package wrote on its 2-device
    `HaloShardedWindowed` (global layout (p, 2 n128))."""
    from lanczos_tpu.methods import checkpoint as jax_ck

    jop = _jax_windowed(cases.REPAIR_RANKS, "lap40", jnp.float64)
    B = _start_block(jop)
    want = jax_ck.block_lanczos_checkpointed(
        jop, jop.pad_vector(B.numpy()), cases.JAX_CK_M,
        jop.local_index(cases.ELL_LC))
    for r in ranks(cases.REPAIR_RANKS):
        got = r["repairs"]["jax_resumed", "windowed"]
        for g, w in zip(got, (want.alphas, want.betas, want.trace, want.beta_final)):
            _assert_scaled(g, np.asarray(w), 1e-10)


# -- the row-sharded windowed-ELL operator on the ranks ---------------------------
# (tests/test_torch_dist_windowed.py holds its layout and by-hand products
# in one process)

WIN_RTOL = {"float32": 1e-5, "float64": 1e-12}
WIN_CHAIN_RTOL = {"float32": 1e-4, "float64": 1e-10}  # test_dist_windowed.py:46-55
WIN_EIGSH_RTOL = 1e-3  # tests/test_dist_windowed.py:106
# the port's f32 Ritz values against JAX's on the same operator and start
WIN_JAX_RITZ_RTOL = 1e-4


def _win_local(k, rank, name, dtype=torch.float64):
    from lanczos_tpu_torch.parallel.dist_windowed import halo_sharded_windowed

    a, reorder = cases.windowed_matrices()[name]
    return halo_sharded_windowed(a, Mesh(rank, k, torch.device("cpu"), None),
                                 dtype=dtype, reorder=reorder, cpb=2, spg=2)


def _win_strips(res, name, dname, key):
    return torch.stack([r["windowed"]["products"][name, dname][key] for r in res])


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("name", list(cases.windowed_matrices()))
@pytest.mark.parametrize("k", RANKS)
def test_windowed_products_match_scipy(k, name, dname, ranks):
    """mv and mm on the k ranks (K8's plain version on each rank's shard
    after the halo exchange), stitched, against scipy's product (f32 to
    1e-5 of scale, f64 to 1e-12); unpad_vector inverts pad_vector
    exactly on every rank."""
    res = ranks(k)
    a = cases.windowed_matrices()[name][0]
    b, B = cases.windowed_start(a.shape[0], torch.float64)
    op = _win_local(k, 0, name, cases.DTYPES[dname])
    for key, x in (("mv", b), ("mm", B)):
        got = op.unpad_shards(_win_strips(res, name, dname, key))
        _assert_scaled(got, (a @ x.numpy().T).T, WIN_RTOL[dname])
    for r in res:
        got = r["windowed"]["products"][name, dname]["roundtrip"]
        torch.testing.assert_close(got, B.to(got.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("k", RANKS)
def test_windowed_chain_keeps_halos_zero(k, ranks):
    """Two chained products (JAX's test_chain_preserves_zero_halos): every
    strip's halo slots and pads stay exactly zero, the result matches
    scipy's A(A X), and the sum of squares over the strips is the
    unpadded one's."""
    res = ranks(k)
    for name, (a, _) in cases.windowed_matrices().items():
        _, B = cases.windowed_start(a.shape[0], torch.float64)
        want = (a @ (a @ B.numpy().T)).T
        for dname in DTYPES:
            strips = _win_strips(res, name, dname, "chain")
            ops = [_win_local(k, rank, name, cases.DTYPES[dname]) for rank in range(k)]
            rows = [max(0, min(op.rows_loc, a.shape[0] - rank * op.rows_loc))
                    for rank, op in enumerate(ops)]
            for rank, (op, y) in enumerate(zip(ops, strips)):
                outside = y.clone()
                outside[:, op.halo : op.halo + rows[rank]] = 0
                assert not outside.any(), (name, dname, rank)
            _assert_scaled(ops[0].unpad_shards(strips), want, WIN_CHAIN_RTOL[dname])
            full = float((strips.double() ** 2).sum())
            assert full == pytest.approx(float((want ** 2).sum()),
                                         rel=WIN_CHAIN_RTOL[dname])


@pytest.mark.parametrize("k", RANKS)
def test_windowed_eigsh_matches_dense_and_jax(k, ranks):
    """block_lanczos_eigsh (p=3, m=12, reorth full, f32) on the spiked
    Laplacian: the top 3 within 1e-3 of the dense spectrum
    (tests/test_dist_windowed.py:94-106), within 1e-4 of JAX's eigsh on
    its operator on make_mesh(k), and the same on every rank."""
    from lanczos_tpu.methods.eigs import block_lanczos_eigsh as jax_eigsh

    res = ranks(k)
    a = cases.windowed_matrices()["spiked"][0]
    want = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][: cases.WIN_EIGSH_K]
    jop = _jax_windowed(k, "spiked")
    B = cases.windowed_start(a.shape[0], torch.float32)[1]
    jvals, _, _ = jax_eigsh(jop, jop.pad_vector(B.numpy()), cases.WIN_EIGSH_M,
                            cases.WIN_EIGSH_K, reorth="full")
    for r in res:
        vals = r["windowed"]["eigsh"].numpy()
        np.testing.assert_allclose(vals, want, rtol=WIN_EIGSH_RTOL)
        np.testing.assert_allclose(vals, np.asarray(jvals), rtol=WIN_JAX_RITZ_RTOL)
        torch.testing.assert_close(r["windowed"]["eigsh"], res[0]["windowed"]["eigsh"],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("k", RANKS)
def test_windowed_io_and_auto_with_a_mesh(k, ranks):
    """operator_from_file(mesh=) with "windowed" and "auto" builds
    HaloShardedWindowed; auto_operator(mesh=) on a matrix whose first
    shard has too many planes a chunk falls back to the halo ELL on every
    rank, with a warning, as JAX's auto does on make_mesh(k), and its
    product matches scipy."""
    from lanczos_tpu.io import auto_operator as jax_auto

    want_type = type(jax_auto(cases.plan_error_matrix(), mesh=jax_make_mesh(k),
                              dtype=jnp.float64)).__name__
    assert want_type == "HaloShardedEll"
    a = cases.plan_error_matrix()
    _, B = cases.windowed_start(a.shape[0], torch.float64)
    res = ranks(k)
    for r in res:
        io = r["windowed"]["io"]
        assert io["types"] == ["HaloShardedWindowed"] * 2
        assert io["fallback"] == want_type
        assert any("windowed-ELL plan failed" in w for w in io["fallback_warnings"])
    # the shard that exceeds the cap is rank 0's; every other rank falls
    # back because of it
    assert "planes/chunk" in res[0]["windowed"]["io"]["fallback_warnings"][0]
    from lanczos_tpu_torch.parallel import dist_operator as D

    op = D.halo_sharded_ell(a, Mesh(0, k, torch.device("cpu"), None), dtype=torch.float64)
    got = op.unpad_shards(torch.stack([r["windowed"]["io"]["fallback_mm"] for r in res]))
    _assert_scaled(got, (a @ B.numpy().T).T, WIN_RTOL["float64"])


@pytest.mark.parametrize("k", RANKS)
def test_dryrun_rank_matches_jax(k, ranks):
    """The dry run's three steps on the k ranks: its windowed (qr-TSQR) and
    halo-ELL top Ritz values against JAX's block_lanczos_eigsh on its
    operators on make_mesh(k) (the third and second steps of
    __graft_entry__.dryrun_multichip), the same on every rank."""
    from lanczos_tpu.methods.eigs import block_lanczos_eigsh as jax_eigsh
    from lanczos_tpu.models.laplacian import laplacian_2d_scipy as jax_lap
    from lanczos_tpu.parallel import halo_sharded_ell as jh
    from lanczos_tpu.parallel.dist_windowed import halo_sharded_windowed as jw
    from lanczos_tpu_torch.parallel import dryrun

    a = jax_lap(16, 3 * k)
    x = np.random.default_rng(0).standard_normal((dryrun.P, a.shape[0])).astype(np.float32)
    jop = jh(a, jax_make_mesh(k), dtype=jnp.float32)
    want, _, _ = jax_eigsh(jop, jop.pad_vector(x), dryrun.M, 2, which="LA")
    jw_op = jw(a, jax_make_mesh(k), cpb=2, spg=2)
    want_w, _, _ = jax_eigsh(jw_op, jw_op.pad_vector(x), dryrun.M, 2, which="LA",
                             normalize="qr", breakdown_eps=1e-6, replace_dead=True)
    res = ranks(k)
    for r in res:
        got = r["windowed"]["dryrun"]
        np.testing.assert_allclose(got["vals"].numpy(), np.asarray(want),
                                   rtol=WIN_JAX_RITZ_RTOL)
        np.testing.assert_allclose(got["vals_w"].numpy(), np.asarray(want_w),
                                   rtol=WIN_JAX_RITZ_RTOL)
        torch.testing.assert_close(got["vals_w"], res[0]["windowed"]["dryrun"]["vals_w"],
                                   rtol=0, atol=0)
