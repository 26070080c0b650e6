"""Run a function on N ranks, one process per device (the counterpart of
the JAX package's single-controller mesh creation).

    results = launch.run(fn, n_devices, *args, device="cuda", timeout=600)

`fn(mesh, *args)` runs in every rank with that rank's `mesh.Mesh`; `run`
returns the ranks' results in rank order, each moved to the CPU.  Each
rank is a spawned process that sets its card (`torch.cuda.set_device`)
before anything launches, then joins the group (NCCL on CUDA, gloo on the
CPU) through a `FileStore` in a temporary directory, so concurrent runs
never compete for a port.  The parent builds the CUDA kernels once before
spawning, so the ranks load one library instead of each running nvcc.

The parent waits at most `timeout` seconds (None: until the ranks end),
and terminates the ranks that are still running when it stops waiting.
A rank's exception is raised in the parent, with the rank's traceback
attached as a note; a rank that dies without a result, or a run that
outlasts its timeout, raises as well.  Nothing falls back: there is no
other backend and no single-process path.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch

from lanczos_tpu_torch.parallel.mesh import check_devices

_POLL_S = 0.5
_JOIN_S = 10.0


def run(fn, n_devices: int, *args, device="cuda", timeout: float | None = 600.0):
    """fn(mesh, *args) on `n_devices` ranks; returns their results in rank
    order.  ValueError, before any process starts, when the machine has
    fewer cards than `n_devices` (CPU ranks take any count)."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    check_devices(n_devices, device_type)
    if device_type == "cuda":
        from lanczos_tpu_torch.ops.kernels import build

        build.library()
    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="lanczos_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(rank, n_devices, device_type, store, timeout,
                              fn, args, results_q))
            for rank in range(n_devices)
        ]
        for p in procs:
            p.start()
        try:
            return _collect(results_q, procs, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(_JOIN_S)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(results_q, procs, timeout):
    n = len(procs)
    deadline = None if timeout is None else time.monotonic() + timeout
    results, pending = [None] * n, set(range(n))
    while pending:
        try:
            rank, ok, payload = results_q.get(timeout=_POLL_S)
        except queue_mod.Empty:
            dead = [r for r in pending if procs[r].exitcode is not None]
            if dead:
                # a rank's last message reaches the queue before it exits
                try:
                    rank, ok, payload = results_q.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    r = min(dead)
                    raise RuntimeError(
                        f"rank {r} of {n} exited with code "
                        f"{procs[r].exitcode} without a result"
                    ) from None
            elif deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {n} did not finish within "
                    f"{timeout} s"
                ) from None
            else:
                continue
        if not ok:
            exc, tb = pickle.loads(payload)
            exc.add_note(f"raised on rank {rank} of {n}:\n{tb}")
            raise exc
        results[rank] = pickle.loads(payload)
        pending.discard(rank)
    return results


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _error_payload(exc: BaseException) -> bytes:
    tb = traceback.format_exc()
    try:
        return pickle.dumps((exc, tb))
    except Exception:  # an exception that does not pickle comes back as text
        return pickle.dumps((RuntimeError(f"{type(exc).__name__}: {exc}"), tb))


def _rank_main(rank, n, device_type, store_path, timeout, fn, args, results_q):
    import torch.distributed as dist

    from lanczos_tpu_torch.parallel.mesh import make_mesh

    joined = False
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            backend = "nccl"
        else:
            backend = "gloo"
            # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n, **kw)
        joined = True
        result = fn(make_mesh(n, device_type), *args)
        if device_type == "cuda":
            torch.cuda.synchronize()
        results_q.put((rank, True, pickle.dumps(_to_cpu(result))))
    except Exception as exc:  # reported to the parent, which raises it
        results_q.put((rank, False, _error_payload(exc)))
    finally:
        if joined:
            dist.destroy_process_group()
