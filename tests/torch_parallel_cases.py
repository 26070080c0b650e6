"""Rank functions of tests/test_torch_parallel.py.

Each runs inside a rank that `lanczos_tpu_torch.parallel.launch.run`
spawned, imports nothing of JAX, and returns tensors (moved to the CPU by
`launch`) that the test compares in its own process with the JAX package
and with the port's single-device operator.  The inputs come from numpy
seeds, so every rank, and the test, makes the same ones.
"""

import numpy as np
import torch

from lanczos_tpu_torch.methods import block_lanczos_fused
from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.ops.tsqr import tsqr_sharded
from lanczos_tpu_torch.parallel import DistributedPallasMaxwell
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


def scenarios(mesh):
    """Everything the test compares at one world size, in one spawn."""
    out = {}
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


def describe(mesh):
    """The mesh as the rank sees it, and its collectives on rank-made data."""
    lo = torch.full((3,), 10.0 * mesh.rank)
    from_left, from_right = mesh.exchange(lo, lo + 1)
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "gather": mesh.all_gather(torch.tensor([float(mesh.rank)])),
            "sum": mesh.all_reduce_(torch.full((2,), float(mesh.rank + 1))),
            "any": mesh.any(mesh.rank == mesh.size - 1), "none": mesh.any(False),
            "from_left": from_left, "from_right": from_right}
