"""Rank functions of tests/test_torch_parallel.py.

Each runs inside a rank that `lanczos_tpu_torch.parallel.launch.run`
spawned, imports nothing of JAX, and returns tensors (moved to the CPU by
`launch`) that the test compares in its own process with the JAX package
and with the port's single-device operator.  The inputs come from numpy
seeds, so every rank, and the test, makes the same ones.
"""

import os
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from lanczos_tpu_torch.methods import block_lanczos_fused
from lanczos_tpu_torch.methods import checkpoint as ck
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.eigs import (
    block_lanczos_eigsh,
    lanczos_eigsh,
    ritz_residuals,
)
from lanczos_tpu_torch.methods.expm_action import (
    block_lanczos_expm_action,
    lanczos_expm_action,
)
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
from lanczos_tpu_torch.models.maxwell import assemble_maxwell_A
from lanczos_tpu_torch.ops.tsqr import tsqr_sharded
from lanczos_tpu_torch.parallel import (
    DistributedPallasMaxwell,
    gather_sharded_ell,
    halo_sharded_ell,
    halo_sharded_windowed,
)
from lanczos_tpu_torch.parallel.dist_stencil import slab_rows

# z extent 30: with tz = 8 every rank of 1, 2 and 4 holds interior planes
GRID = (4, 5, 29)
P, M, SEED = 3, 6, 7
LC = 512  # plane z = 20 of component 0: rank 0, 1 and 2 of k = 1, 2, 4
FDTD_STEPS = 10
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# (kind, reorth, normalize)
LANCZOS_CASES = (
    ("vector", "none", None), ("vector", "full", None),
    ("vector", "selective", None),
    ("block", "none", "sqrtm"), ("block", "full", "sqrtm"),
    ("block", "none", "qr"), ("block", "full", "qr"),
    ("block", "periodic", "qr"), ("block", "selective", "sqrtm"),
)
# tests/test_tsqr.py:78-130's inputs: name -> (seed, shape, zeroed columns)
TSQR_CASES = {
    "matches_local": (3, (6, 1024), None),
    "orthonormal": (4, (4, 2048), None),
    "zero_pad_rows": (5, (4, 2048), (500, 700)),
}
# the 16 MB gate at 2 ranks: one f64 state of a slab holds 6 x 88 x 4096
# x 8 B = 17.3 MB
GATE_GRID, GATE_RANKS = (60, 60, 140), 2


def start(n: int, dtype):
    """(b, B): a start vector and a P-column start block, from the seed."""
    rng = np.random.default_rng(SEED)
    return (torch.from_numpy(rng.standard_normal(n)).to(dtype),
            torch.from_numpy(rng.standard_normal((P, n))).to(dtype))


def tsqr_input(name: str) -> np.ndarray:
    seed, shape, zeroed = TSQR_CASES[name]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zeroed:
        x[:, zeroed[0] : zeroed[1]] = 0.0
    return x


def lanczos(op, kind, reorth, normalize, u, U, trace_fn):
    """One Lanczos case on op (distributed or not) with its default gates:
    (alphas, betas, trace, beta_final)."""
    if kind == "vector":
        r = vector_lanczos(op, u, M, reorth=reorth, trace_fn=trace_fn)
    else:
        r = block_lanczos(op, U, M, reorth=reorth, normalize=normalize,
                          trace_fn=trace_fn)
    return r.alphas, r.betas, r.trace, r.beta_final


def _refusal(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


# -- the row-sharded ELL operators ------------------------------------------

ELL_BUILDERS = {"halo": halo_sharded_ell, "gather": gather_sharded_ell}
ELL_P, ELL_M, ELL_SEED = 3, 8, 13
ELL_LC = 37  # a natural-order receiver
# the f64 Lanczos cases against JAX, and the operators eigsh runs on
ELL_LANCZOS = ("laplacian", "maxwell", "banded")
EIGSH_GRID, EIGSH_M, EIGSH_K = (16, 15), 110, 4  # tests/test_parallel.py:122-133
EXPM_M, EXPM_T = 10, 1.0
# the repairs: checkpointed runs on this many ranks, stopped after a chunk
REPAIR_RANKS, CK_M, CK_CHUNK, CK_STEPS = 2, 7, 3, 10
JAX_CK_FILES = {"halo": "jax_block.npz", "windowed": "jax_windowed_block.npz"}
JAX_CK_STOPPED, JAX_CK_M = 3, 6


def ell_matrices():
    """name -> (scipy matrix, reorder): a 2-D Laplacian (16 x 12), the
    Maxwell operator at N=3 (its [E; H] order is not banded, so "auto"
    applies RCM where the halo exceeds a shard), a random symmetric band
    of half-width 4, and an arrow matrix without reordering (a halo of
    several shards: k-hop exchanges at 4 ranks)."""
    rng = np.random.default_rng(ELL_SEED)
    n, offs = 150, list(range(-4, 5))
    band = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs)
    arrow = sp.lil_matrix((256, 256))
    arrow.setdiag(2.0)
    arrow[0, :] = 1.0
    arrow[:, 0] = 1.0
    return {"laplacian": (laplacian_2d_scipy(16, 12).tocsr(), "auto"),
            "maxwell": (assemble_maxwell_A(3, 3, 3), "auto"),
            "banded": ((band + band.T).tocsr(), "auto"),
            "arrow": (arrow.tocsr(), "none")}


def ell_start(n: int, dtype):
    """(b, B): a natural-order start vector and ELL_P-column block."""
    rng = np.random.default_rng(ELL_SEED)
    return (torch.from_numpy(rng.standard_normal(n)).to(dtype),
            torch.from_numpy(rng.standard_normal((ELL_P, n))).to(dtype))


def ell_op(mesh, name, builder, dtype=torch.float64):
    a, reorder = ell_matrices()[name]
    if builder == "halo":
        return halo_sharded_ell(a, mesh, dtype=dtype, reorder=reorder)
    return gather_sharded_ell(a, mesh, dtype=dtype)


def expm_receivers(op) -> list[int]:
    """Natural-order receivers whose rows lie on the first, a middle and
    the last shard of op's mesh."""
    k, rows, n = op.mesh.size, op.rows_loc, op.n_rows_true
    perm = np.arange(n) if op.perm is None else op.perm
    return [int(perm[i]) for i in (1, (k // 2) * rows + rows // 3, n - 1)]


def ell_scenarios(mesh):
    """The row-sharded ELL operators on this mesh: products, round trips,
    Lanczos, eigsh and expm."""
    out = {"products": {}, "lanczos": {}, "eigsh": {}}
    mats = ell_matrices()
    for name, (a, _) in mats.items():
        for builder in ELL_BUILDERS:
            for dname, dtype in DTYPES.items():
                op = ell_op(mesh, name, builder, dtype)
                b, B = ell_start(a.shape[0], dtype)
                out["products"][name, builder, dname] = {
                    "mv": op.mv(op.pad_vector(b)), "mm": op.mm(op.pad_vector(B)),
                    "roundtrip": op.unpad_vector(op.pad_vector(B)),
                    "roundtrip1": op.unpad_vector(op.pad_vector(b)),
                    "halo": op.halo, "rows_loc": op.rows_loc}
    for name in ELL_LANCZOS:
        for builder in ELL_BUILDERS:
            op = ell_op(mesh, name, builder)
            b, B = ell_start(op.n_rows_true, torch.float64)
            lc = op.local_index(ELL_LC)
            v = vector_lanczos(op, op.pad_vector(b), ELL_M, lc)
            w = block_lanczos(op, op.pad_vector(B), ELL_M // 2, lc)
            out["lanczos"][name, builder] = {
                "vector": (v.alphas, v.betas, v.trace, v.beta_final),
                "block": (w.alphas, w.betas, w.trace, w.beta_final)}
    lap = laplacian_2d_scipy(*EIGSH_GRID).tocsr()
    b = torch.from_numpy(np.random.default_rng(ELL_SEED).standard_normal(lap.shape[0]))
    for builder, build in ELL_BUILDERS.items():
        op = build(lap, mesh, dtype=torch.float64)
        vals, _, _ = lanczos_eigsh(op, op.pad_vector(b), EIGSH_M, EIGSH_K,
                                   which="LA", reorth="full")
        out["eigsh"][builder] = vals
    op = ell_op(mesh, "maxwell", "halo")
    b, _ = ell_start(op.n_rows_true, torch.float64)
    lcs = expm_receivers(op)
    out["expm"] = {lc: lanczos_expm_action(op, op.pad_vector(b), EXPM_M, EXPM_T,
                                           op.local_index(lc)) for lc in lcs}
    return out


# -- the row-sharded windowed-ELL operator -----------------------------------

WIN_P, WIN_SEED = 3, 7
WIN_EIGSH_M, WIN_EIGSH_K = 12, 3  # tests/test_dist_windowed.py:100-106


def windowed_matrices():
    """name -> (scipy matrix, reorder): tests/test_dist_windowed.py's
    fixtures.  The 60 x 60 and 40 x 40 Laplacians; a 30 x 30 Laplacian
    plus random noise in a band of half-width 300 (n=900: a halo of two
    128-row shards), unreordered; a 2 x 200 bipartite matrix, which "rcm"
    reorders; the 40 x 40 Laplacian with three spikes on its diagonal."""
    n = 900
    d = sp.random(n, n, density=0.002, random_state=3, format="coo")
    keep = np.abs(d.row - d.col) <= 300
    d = sp.coo_matrix((d.data[keep], (d.row[keep], d.col[keep])), shape=(n, n))
    n2 = 200
    b = sp.diags([np.ones(n2), 0.5 * np.ones(n2 - 1)], [0, 1], shape=(n2, n2))
    spikes = np.zeros(1600)
    spikes[:3] = [10.0, 8.0, 6.0]
    return {"lap60": (laplacian_2d_scipy(60, 60).tocsr(), "auto"),
            "lap40": (laplacian_2d_scipy(40, 40).tocsr(), "auto"),
            "band300": ((laplacian_2d_scipy(30, 30) + d + d.T).tocsr(), "none"),
            "bipartite": (sp.bmat([[None, b], [b.T, None]]).tocsr(), "rcm"),
            "spiked": ((laplacian_2d_scipy(40, 40) + sp.diags(spikes)).tocsr(), "auto")}


def plan_error_matrix():
    """A 512-row matrix whose first 16 rows hold 60 nonzeros each: more
    planes a chunk than the windowed plan's cap of 48, on the first shard
    only at 2 or 4 ranks; the halo ELL takes it."""
    a = sp.lil_matrix((512, 512))
    a.setdiag(2.0)
    for i in range(16):
        a[i, :60] = 1.0
    a = a.tocsr()
    return (a + a.T).tocsr()


def windowed_start(n: int, dtype):
    """(b, B): a natural-order start vector and WIN_P-column block."""
    rng = np.random.default_rng(WIN_SEED)
    return (torch.from_numpy(rng.standard_normal(n)).to(dtype),
            torch.from_numpy(rng.standard_normal((WIN_P, n))).to(dtype))


def windowed_op(mesh, name, dtype=torch.float64):
    a, reorder = windowed_matrices()[name]
    return halo_sharded_windowed(a, mesh, dtype=dtype, reorder=reorder, cpb=2, spg=2)


def windowed_scenarios(mesh, tmp):
    """The row-sharded windowed-ELL operator on this mesh: products (one
    chained), eigsh, io and auto with a mesh, and the dry run."""
    from lanczos_tpu_torch.io import auto_operator, operator_from_file
    from lanczos_tpu_torch.parallel.dryrun import dryrun_rank

    out = {"products": {}}
    for name, (a, _) in windowed_matrices().items():
        for dname, dtype in DTYPES.items():
            op = windowed_op(mesh, name, dtype)
            b, B = windowed_start(a.shape[0], dtype)
            U = op.pad_vector(B)
            out["products"][name, dname] = {
                "mv": op.mv(op.pad_vector(b)), "mm": op.mm(U),
                "chain": op.mm(op.mm(U)), "roundtrip": op.unpad_vector(U)}
    a = windowed_matrices()["spiked"][0]
    op = windowed_op(mesh, "spiked", torch.float32)
    _, B = windowed_start(a.shape[0], torch.float32)
    vals, _, _ = block_lanczos_eigsh(op, op.pad_vector(B), WIN_EIGSH_M, WIN_EIGSH_K,
                                     reorth="full")
    out["eigsh"] = vals
    path = os.path.join(tmp, "win.npz")
    if mesh.rank == 0:
        sp.save_npz(path, windowed_matrices()["lap40"][0])
    mesh.barrier()
    pe = plan_error_matrix()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback = auto_operator(pe, mesh=mesh, dtype=torch.float64)
    _, B = windowed_start(pe.shape[0], torch.float64)
    out["io"] = {
        "types": [type(operator_from_file(path, format=f, mesh=mesh)).__name__
                  for f in ("windowed", "auto")],
        "fallback": type(fallback).__name__,
        "fallback_warnings": [str(w.message) for w in caught],
        "fallback_mm": fallback.mm(fallback.pad_vector(B))}
    out["dryrun"] = dryrun_rank(mesh)
    return out


class StopAfterFirstChunk(Exception):
    pass


def _stopping_after_first_save(real):
    """`_Sharding.write` that raises on every rank once its first save is in
    place: the run stops after one chunk, as a killed job would."""
    calls = []

    def write(self, save):
        if calls:
            raise StopAfterFirstChunk
        calls.append(1)
        return real(self, save)

    return write


def _stopped_then_resumed(run, path):
    real = ck._Sharding.write
    ck._Sharding.write = _stopping_after_first_save(real)
    try:
        run(path)
        raise AssertionError("the checkpointed run did not stop")
    except StopAfterFirstChunk:
        pass
    finally:
        ck._Sharding.write = real
    with np.load(path) as z:
        stopped_at = int(z["j"] if "j" in z else z["step"])
    return stopped_at, run(path)


def _result(r):
    return (r.alphas, r.betas, r.trace, r.beta_final)


def repairs(mesh, tmp):
    """The checkpointed drivers and ritz_residuals on a distributed
    operator: each checkpointed run is stopped after its first chunk and
    resumed (one directory a run), beside the monolithic fused=False run."""
    out = {}
    zslab = DistributedPallasMaxwell.create(*GRID, mesh, dtype=torch.float64)
    b, B = start(zslab.n, torch.float64)
    c, z, ps = zslab.state_index(LC)
    lc_slab = int(np.ravel_multi_index((c, z, ps), (6, mesh.size * zslab.spec_e.zc,
                                                     zslab.spec_e.plane)))
    halo = ell_op(mesh, "laplacian", "halo")
    hb, hB = ell_start(halo.n_rows_true, torch.float64)
    win = windowed_op(mesh, "lap40")
    wb, wB = windowed_start(win.n_rows_true, torch.float64)
    ops = {"zslab": (zslab, zslab.pack(b), zslab.pack(B), lc_slab),
           "halo": (halo, halo.pad_vector(hb), halo.pad_vector(hB),
                    halo.local_index(ELL_LC)),
           "windowed": (win, win.pad_vector(wb), win.pad_vector(wB),
                        win.local_index(ELL_LC))}
    for name, (op, u, U, lc) in ops.items():
        runs = {
            "vector": (lambda p, op=op, u=u, lc=lc: ck.vector_lanczos_checkpointed(
                op, u, CK_M, lc, chunk=CK_CHUNK, path=p),
                lambda: vector_lanczos(op, u, CK_M, lc, fused=False)),
            "block": (lambda p, op=op, U=U, lc=lc: ck.block_lanczos_checkpointed(
                op, U, CK_M, lc, chunk=CK_CHUNK, path=p),
                lambda: block_lanczos(op, U, CK_M, lc, fused=False)),
            "fdtd": (lambda p, op=op, U=U: ck.fdtd_checkpointed(
                op, U, CK_STEPS, 0.1, chunk=CK_CHUNK, path=p, block=True),
                lambda: fdtd_block(op, U, CK_STEPS, 0.1)),
        }
        for kind, (chunked, whole) in runs.items():
            d = os.path.join(tmp, f"{name}-{kind}")
            if mesh.rank == 0:
                os.makedirs(d)
            mesh.barrier()
            stopped_at, got = _stopped_then_resumed(chunked, os.path.join(d, "ck.npz"))
            want = whole()
            if kind != "fdtd":
                got, want = _result(got), _result(want)
            out[name, kind] = {"got": got, "want": want, "stopped_at": stopped_at,
                               "files": sorted(os.listdir(d))}
        vals, vecs, _ = block_lanczos_eigsh(op, U, CK_M, 2, compute_vectors=True)
        out[name, "ritz"] = {"vals": vals, "vecs": vecs,
                             "resid": ritz_residuals(op, vals, vecs)}
    # written by the JAX package before the spawn, on its halo ELL and its
    # windowed operator
    for key, (op, U) in {"halo": (halo, halo.pad_vector(hB)),
                         "windowed": (win, win.pad_vector(wB))}.items():
        jax_file = os.path.join(tmp, JAX_CK_FILES[key])
        if os.path.exists(jax_file):
            out["jax_resumed", key] = _result(ck.block_lanczos_checkpointed(
                op, U, JAX_CK_M, op.local_index(ELL_LC), chunk=CK_CHUNK,
                path=jax_file))
    return out


def scenarios(mesh, tmp=None):
    """Everything the test compares at one world size, in one spawn; tmp is
    a directory every rank can reach (the checkpoint repairs)."""
    out = {"ell": ell_scenarios(mesh)}
    if tmp is not None:
        out["windowed"] = windowed_scenarios(mesh, tmp)
    if mesh.size == REPAIR_RANKS and tmp is not None:
        out["repairs"] = repairs(mesh, tmp)
    for name, dtype in DTYPES.items():
        op = DistributedPallasMaxwell.create(*GRID, mesh, dtype=dtype)
        b, B = start(op.n, dtype)
        u, U = op.pack(b), op.pack(B)
        tf = op.trace_fn(LC)
        r = out[name] = {
            "pack": U, "pack1": u, "roundtrip": op.unpack(U),
            "mv": op.mv(u), "mm": op.mm(U),
            "expm": block_lanczos_expm_action(op, U, M, 1.0, 0, trace_fn=tf),
            "fdtd": fdtd_block(op, U, FDTD_STEPS, 1.0),
            "fdtd_vector": fdtd_vector(op, u, FDTD_STEPS, 1.0),
        }
        r["lanczos"] = {case: lanczos(op, *case, u, U, tf)
                        for case in LANCZOS_CASES}
    # a 2-row pad: every product moves data across the slab edges
    op = DistributedPallasMaxwell.create(*GRID, mesh, dtype=torch.float64, tz=2)
    out["tz2_mm"] = op.mm(op.pack(start(op.n, torch.float64)[1]))

    op = DistributedPallasMaxwell.create(*GRID, mesh)
    b, B = start(op.n, torch.float32)
    u, U = op.pack(b), op.pack(B)
    out["refusals"] = {
        "block fused=True": _refusal(lambda: block_lanczos(op, U, 3, fused=True)),
        "block compensated=True": _refusal(
            lambda: block_lanczos(op, U, 3, compensated=True)),
        "vector fused=True": _refusal(lambda: vector_lanczos(op, u, 3, fused=True)),
    }
    out["tsqr"] = {}
    for name in TSQR_CASES:
        x = tsqr_input(name)
        cols = x.shape[1] // mesh.size
        mine = x[:, mesh.rank * cols : (mesh.rank + 1) * cols]
        out["tsqr"][name] = tsqr_sharded(torch.from_numpy(mine), mesh)
    if mesh.size == GATE_RANKS:
        out["gate"] = gate(mesh)
    return out


def gate(mesh):
    """fused=None on states over the 16 MB gate: the materialized
    recurrence runs, the fused one (patched to raise here) never does."""

    def refuse(*args, **kwargs):
        raise AssertionError("the fused recurrence ran on a distributed operator")

    real = block_lanczos_fused.block_lanczos_fused
    block_lanczos_fused.block_lanczos_fused = refuse
    try:
        op = DistributedPallasMaxwell.create(*GATE_GRID, mesh, dtype=torch.float64)
        _, zs = slab_rows(GATE_GRID[2], mesh.size)
        assert op.state_shape[1] == zs
        b, B = start(op.n, torch.float64)
        u, U = op.pack(b), op.pack(B[:2])
        tf = op.trace_fn(LC)
        vec = vector_lanczos(op, u, 2, trace_fn=tf)
        blk = block_lanczos(op, U, 2, trace_fn=tf)
        vec_ref = vector_lanczos(op, u, 2, trace_fn=tf, fused=False)
        blk_ref = block_lanczos(op, U, 2, trace_fn=tf, fused=False)
    finally:
        block_lanczos_fused.block_lanczos_fused = real
    return {"state_bytes": u.numel() * u.element_size(),
            "vector": (vec.alphas, vec.betas, vec_ref.alphas, vec_ref.betas),
            "block": (blk.alphas, blk.betas, blk_ref.alphas, blk_ref.betas)}


def raise_on(mesh, rank, exc_type):
    """Raises exc_type on one rank; the others wait in a collective."""
    if mesh.rank == rank:
        raise exc_type(f"raised on purpose on rank {rank}")
    mesh.all_reduce_(torch.ones(1))
    return mesh.rank


def exit_on(mesh, rank):
    """One rank dies without a result; the others (if any) wait in a
    collective."""
    import os

    if mesh.rank == rank:
        os._exit(3)
    mesh.all_reduce_(torch.ones(1))
    return mesh.rank


def sleep(mesh, seconds):
    import time

    time.sleep(seconds)
    return mesh.rank


WINDOW_ROWS, WINDOW_HALOS = 4, (0, 1, 4, 6, 9)  # 1, 1, 2 and 3 hops


def describe(mesh):
    """The mesh as the rank sees it, and its collectives on rank-made data."""
    lo = torch.full((3,), 10.0 * mesh.rank)
    from_left, from_right = mesh.exchange(lo, lo + 1)
    rows = torch.arange(WINDOW_ROWS, dtype=torch.float64) + 10.0 * mesh.rank + 1
    block = torch.stack([rows, -rows])  # (2, WINDOW_ROWS), block-major
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "gather": mesh.all_gather(torch.tensor([float(mesh.rank)])),
            "sum": mesh.all_reduce_(torch.full((2,), float(mesh.rank + 1))),
            "any": mesh.any(mesh.rank == mesh.size - 1), "none": mesh.any(False),
            "from_left": from_left, "from_right": from_right,
            "windows": {h: mesh.halo_window(block, h) for h in WINDOW_HALOS}}


def disagreeing_escalation(mesh):
    """`bench_loop.slope_time_chain` of a chain that all-reduces, where
    only rank 1 would escalate k2 (its timer reads 0 s against a 1 s delta
    to clear; rank 0 clears any delta).  Returns the k2s this rank tried: with the
    group's agreement both ranks try the same ones, without it rank 1
    would wait in the chain's all-reduce for a rank that had stopped."""
    from lanczos_tpu_torch.utils import bench_loop

    tried = []
    real_slope = bench_loop._slope

    def spy(chain, timer, k1, k2, trials):
        tried.append(k2)
        return real_slope(chain, timer, k1, k2, trials)

    class Frozen(bench_loop.Timer):
        def stop(self):
            super().stop()
            return 0.0

    bench_loop._slope = spy
    if mesh.rank == 1:
        bench_loop.Timer = Frozen
    bench_loop.slope_time_chain(mesh.all_reduce_, torch.ones(1), k1=2, k2=12,
                                trials=1, damp=None, k2_max=96,
                                min_delta_s=-np.inf if mesh.rank == 0 else 1.0,
                                group=mesh.group)
    return tried
