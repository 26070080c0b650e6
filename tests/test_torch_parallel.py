"""The port's z-slab multi-device layer (`lanczos_tpu_torch/parallel/`,
`ops/tsqr.py` `tsqr_sharded`) on k = 1, 2 and 4 gloo ranks on the CPU,
against the JAX package's `DistributedPallasMaxwell` and `tsqr_sharded`
on `make_mesh(k)` of conftest's 8 virtual devices (Pallas in interpret
mode), and against the port's single-device `PallasMaxwellOperator`.

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
def ranks():
    """k -> the k ranks' scenario results, one spawn per k, made once."""
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = launch.run(cases.scenarios, k, device="cpu",
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


def test_rank_functions_import_no_jax():
    """The ranks import the port and tests/torch_parallel_cases.py only."""
    import subprocess
    import sys

    code = ("import sys; import tests.torch_parallel_cases; "
            "import lanczos_tpu_torch.parallel.launch; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'lanczos_tpu.')) "
            "for m in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
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
