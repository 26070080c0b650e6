"""Checkpoint / resume for long Lanczos and FDTD runs (port of
`lanczos_tpu/methods/checkpoint.py`).

Both integrators run in restartable chunks: the three-term recurrence's
full state is two live vectors (or blocks) and the coefficient history, so
a checkpoint is exact.  The CLI's FDTD oracle defaults to 10^6 steps; run
through `fdtd_checkpointed`, a failure costs at most one chunk.

Format: one .npz per checkpoint, written to a temporary file in the
target's directory and renamed over it, with the JAX package's keys (j, m,
alphas, betas, trace, q_prev, w for Lanczos; u, step, nsteps, t_end for
FDTD).  States keep their native layout, the folded-plane (p, 6, Zc, P)
one included, which is the JAX package's, so a checkpoint written by
`lanczos_tpu` resumes here and one written here resumes there.

Where the JAX package runs a chunk as one jitted `lax.scan`, this runs the
same steps in a Python loop over the materialized recurrences' own
helpers, so `vector_lanczos_checkpointed` follows `vector_lanczos(...,
fused=False)` and `block_lanczos_checkpointed` follows `block_lanczos(...,
fused=False)` step for step (reorth="none").  `fdtd_checkpointed` runs the
loop of `methods/fdtd.py` itself, so on the folded-plane operator every
step is one K5 launch and a chunked run equals `fdtd_block` /
`fdtd_vector` bit for bit.

On an operator with a `mesh` (the z-slab `DistributedPallasMaxwell`, the
row-sharded `HaloShardedEll`/`GatherShardedEll`) each rank holds its rows
of every state, and the steps sum every norm, dot and Gram over the ranks
as the drivers do (`block_lanczos.py`); the receiver defaults to the
operator's `storage_trace_fn` and each chunk's trace is summed over the
ranks.  A save is still one file in the JAX package's global layout:
every rank all-gathers the states along the operator's `shard_axis`
((p, 6, n_dev Zs, P) for the z-slab operator, (p, n_pad) for the ELL
ones), rank 0 writes, and every rank waits until the file is in place.
On resume every rank reads the file and takes its own rows.  On one
device none of this runs: no collective, no extra synchronisation.

No driver here takes a bf16 state (ValueError before any work): NumPy has
no bf16, and the JAX package writes a bf16 run's states as raw 2-byte
records (|V2) that its own resume cannot read back.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from lanczos_tpu_torch.methods.block_lanczos import (
    BlockLanczosResult,
    _gram,
    _local,
    _mix,
    _sym,
)
from lanczos_tpu_torch.methods.fdtd import euler_steps
from lanczos_tpu_torch.methods.vector_lanczos import VectorLanczosResult
from lanczos_tpu_torch.ops.operator import state_trace
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm


def _atomic_savez(path: str, **arrays) -> None:
    """Write-then-rename .npz.  mkstemp gets the .npz suffix so np.savez
    writes INTO the created temp file (a suffixless temp would leave a
    stray zero-byte file behind every save); on any failure the temp file
    is removed."""
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _refuse_bf16(x: torch.Tensor) -> None:
    if x.dtype == torch.bfloat16:
        raise ValueError("checkpointed runs take float32 or float64 states, "
                         "not bfloat16 (an .npz has no bfloat16)")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _Sharding:
    """How a run's states meet the file.  On one device they are saved and
    loaded as they are.  On a mesh `host` all-gathers a state into the
    global layout (a collective), `write` saves on rank 0 and returns on
    every rank once the file is in place, `exists` is one answer for all
    ranks, and `local` takes this rank's rows of a saved global state."""

    def __init__(self, a):
        self.mesh = getattr(a, "mesh", None)
        self.total = _local if self.mesh is None else self.mesh.all_reduce_
        self.axis = getattr(a, "shard_axis", None)

    def host(self, x: torch.Tensor) -> np.ndarray:
        if self.mesh is not None:
            x = torch.cat(list(self.mesh.all_gather(x)), dim=self.axis)
        return _host(x)

    def write(self, save) -> None:
        if self.mesh is None:
            save()
            return
        if self.mesh.rank == 0:
            save()
        self.mesh.barrier()

    def exists(self, path: str) -> bool:
        found = os.path.exists(path)
        return found if self.mesh is None else self.mesh.any(found)

    def local(self, arr: np.ndarray, device) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.mesh is not None:
            rows = t.shape[self.axis] // self.mesh.size
            t = t.narrow(self.axis, self.mesh.rank * rows, rows)
        return t.to(device)


def _default_trace(a, sh: _Sharding, lc, block: bool):
    lc_idx = 0 if lc is None else int(lc)
    if sh.mesh is not None:
        return a.storage_trace_fn(lc_idx)
    return lambda q: state_trace(q, lc_idx, block=block)


@dataclasses.dataclass
class LanczosCheckpoint:
    """Exact state of a paused single-vector Lanczos run (reorth='none':
    the bare recurrence is memoryless beyond (q_prev, w))."""

    j: int  # completed iterations (alphas[0..j) valid)
    m: int  # target iteration count
    alphas: np.ndarray  # (m,)
    betas: np.ndarray  # (m,)
    trace: np.ndarray  # (m,)
    q_prev: np.ndarray  # (*state,)
    w: np.ndarray  # (*state,)

    def save(self, path: str) -> None:
        _atomic_savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "LanczosCheckpoint":
        with np.load(path) as z:
            return cls(
                j=int(z["j"]), m=int(z["m"]), alphas=z["alphas"],
                betas=z["betas"], trace=z["trace"], q_prev=z["q_prev"], w=z["w"],
            )


class BlockLanczosCheckpoint(LanczosCheckpoint):
    """Exact state of a paused block-Lanczos run (reorth='none'): the same
    keys, with alphas and betas (m, p, p), trace (m, p) and q_prev, w
    (p, *state)."""


def _resume(ck_cls, sh: _Sharding, path, resume: bool, m: int, device):
    """(j, [alphas, betas, trace], q_prev, w) of the checkpoint at path,
    or None when there is none to resume; ValueError if it was written
    for another m."""
    if not (path and resume and sh.exists(path)):
        return None
    ck = ck_cls.load(path)
    if ck.m != m:
        raise ValueError(f"checkpoint {path} was written for m={ck.m}, not m={m}")
    coeffs = [ck.alphas.copy(), ck.betas.copy(), ck.trace.copy()]
    return ck.j, coeffs, sh.local(ck.q_prev, device), sh.local(ck.w, device)


def _run_chunks(step, ck_cls, sh: _Sharding, j, m, coeffs, q_prev, w, chunk,
                path):
    """Iterations j..m-1 of `step(q_prev, w) -> (q, w, alpha, beta,
    trace)`, chunk by chunk: after each chunk its coefficients go into the
    host arrays `coeffs` (alphas, betas, trace; the trace summed over the
    ranks) and, with a path, the whole state into a checkpoint.  Returns
    the final (q_prev, w)."""
    while j < m:
        k = min(chunk, m - j)
        rows = []
        for _ in range(k):
            q_prev, w, *row = step(q_prev, w)
            rows.append(row)
        alphas, betas, trace = (torch.stack(col) for col in zip(*rows))
        for arr, x in zip(coeffs, (alphas, betas, sh.total(trace))):
            arr[j : j + k] = _host(x)
        j += k
        if path:
            q_host, w_host = sh.host(q_prev), sh.host(w)
            sh.write(lambda: ck_cls(j=j, m=m, alphas=coeffs[0], betas=coeffs[1],
                                    trace=coeffs[2], q_prev=q_host,
                                    w=w_host).save(path))
    return q_prev, w


def vector_lanczos_checkpointed(
    a,
    b: torch.Tensor,
    m: int,
    lc=None,
    *,
    chunk: int = 64,
    path: str | None = None,
    resume: bool = True,
    trace_fn=None,
) -> VectorLanczosResult:
    """m-step single-vector Lanczos run in restartable chunks.

    If `path` exists and `resume`, continues from the saved state (its m
    must be this m, else ValueError); a checkpoint is (re)written after
    every chunk.  Matches `vector_lanczos(..., reorth='none',
    fused=False)`.  The coefficients live on the host between chunks; the
    result's tensors are on b's device."""
    _refuse_bf16(b)
    sh = _Sharding(a)
    trace_at = trace_fn or _default_trace(a, sh, lc, block=False)
    dev = b.device

    def dot(x, y):
        return sh.total(torch.sum(x * y))

    def norm(x):
        return torch.sqrt(dot(x, x))

    def step(q_prev, w):
        beta = norm(w)
        q = w / beta
        wn = a.mv(q) - beta * q_prev
        alpha = dot(wn, q)
        return q, wn - alpha * q, alpha, beta, trace_at(q)

    state = _resume(LanczosCheckpoint, sh, path, resume, m, dev)
    if state is None:
        beta0 = norm(b)
        q0 = b / beta0
        w = a.mv(q0)
        alpha0 = dot(w, q0)
        w = w - alpha0 * q0
        coeffs = [np.zeros(m, _host(b[:0]).dtype) for _ in range(3)]
        for arr, x in zip(coeffs, (alpha0, beta0, sh.total(trace_at(q0)))):
            arr[0] = _host(x)
        state = (1, coeffs, q0, w)
    j, coeffs, q_prev, w = state
    q_prev, w = _run_chunks(step, LanczosCheckpoint, sh, j, m, coeffs, q_prev,
                            w, chunk, path)

    alphas, betas, trace = (torch.from_numpy(c).to(dev) for c in coeffs)
    return VectorLanczosResult(
        alphas=alphas,
        betas=betas,
        trace=trace,
        basis=None,
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        beta_final=norm(w),
    )


def block_lanczos_checkpointed(
    a,
    b: torch.Tensor,
    m: int,
    lc=None,
    *,
    chunk: int = 64,
    path: str | None = None,
    resume: bool = True,
    trace_fn=None,
    eig_sweeps: int | None = None,
) -> BlockLanczosResult:
    """m-step block Lanczos in restartable chunks; matches
    `block_lanczos(..., reorth='none', fused=False)` step for step (the
    materialized recurrence with the Jacobi sqrtm; `eig_sweeps` its sweep
    count).  b is BLOCK-MAJOR (p, *state).  An existing `path` with
    `resume` continues the saved run (its m must be this m, else
    ValueError).  Returns a BlockLanczosResult (basis=None) on b's
    device."""
    _refuse_bf16(b)
    p = b.shape[0]
    sh = _Sharding(a)
    trace_at = trace_fn or _default_trace(a, sh, lc, block=True)
    dev = b.device

    def gram(x, y):
        return sh.total(_gram(x, y))

    def step(q_prev, w):
        beta, inv = sqrtm_invsqrtm(gram(w, w), sweeps=eig_sweeps)
        q = _mix(inv, w)
        # the transposed subdiagonal block, as block_lanczos subtracts it
        # (the same matrix up to rounding on this symmetric path)
        wn = a.mm(q) - _mix(beta.T, q_prev)
        alpha = _sym(gram(wn, q))
        return q, wn - _mix(alpha, q), alpha, beta, trace_at(q)

    state = _resume(BlockLanczosCheckpoint, sh, path, resume, m, dev)
    if state is None:
        beta0, inv0 = sqrtm_invsqrtm(gram(b, b), sweeps=eig_sweeps)
        q0 = _mix(inv0, b)
        w = a.mm(q0)
        alpha0 = _sym(gram(w, q0))
        w = w - _mix(alpha0, q0)
        dt = _host(b[:0]).dtype
        coeffs = [np.zeros((m, p, p), dt), np.zeros((m, p, p), dt),
                  np.zeros((m, p), dt)]
        for arr, x in zip(coeffs, (alpha0, beta0, sh.total(trace_at(q0)))):
            arr[0] = _host(x)
        state = (1, coeffs, q0, w)
    j, coeffs, q_prev, w = state
    q_prev, w = _run_chunks(step, BlockLanczosCheckpoint, sh, j, m, coeffs,
                            q_prev, w, chunk, path)

    beta_final, _ = sqrtm_invsqrtm(gram(w, w), sweeps=eig_sweeps)
    alphas, betas, trace = (torch.from_numpy(c).to(dev) for c in coeffs)
    return BlockLanczosResult(
        alphas=alphas,
        betas=betas,
        trace=trace,
        beta_final=beta_final,
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        basis=None,
    )


def fdtd_checkpointed(
    a,
    u0: torch.Tensor,
    nsteps: int,
    t_end: float,
    *,
    chunk: int = 100_000,
    path: str | None = None,
    resume: bool = True,
    block: bool = False,
) -> torch.Tensor:
    """Forward-Euler u += dt A u in restartable chunks (the reference's
    10^6-step oracle, fdtd.hpp:7 / ftdt_block fdtd.hpp:34, with resume).
    `block=True` integrates a block-major (p, *state) state via a.mm.

    A saved run resumes only when its nsteps and t_end are this call's;
    a finished one returns its saved state.  The steps are
    `methods/fdtd.py`'s own loop (`euler_steps`): dt folded into operators
    with `scaled`, one K5 launch a step on the folded-plane operator,
    ping-ponging two buffers that never include u0, so the result equals
    `fdtd_block` / `fdtd_vector` bit for bit."""
    _refuse_bf16(u0)
    dt = torch.tensor(float(t_end) / nsteps, dtype=u0.dtype, device=u0.device)
    sh = _Sharding(a)
    start, u = 0, u0
    if path and resume and sh.exists(path):
        with np.load(path) as z:
            if int(z["nsteps"]) == nsteps and float(z["t_end"]) == float(t_end):
                start = int(z["step"])
                u = sh.local(z["u"], u0.device).to(u0.dtype)

    bufs = None
    if hasattr(a, "scaled"):
        bufs = (torch.empty_like(u0), torch.empty_like(u0))
    while start < nsteps:
        k = min(chunk, nsteps - start)
        u = euler_steps(a, u, k, dt, block=block, bufs=bufs)
        start += k
        if path:
            u_host = sh.host(u)
            sh.write(lambda: _atomic_savez(path, u=u_host, step=start,
                                           nsteps=nsteps, t_end=t_end))
    return u
