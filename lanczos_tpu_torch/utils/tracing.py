"""The port's spans and counters, on `torch.profiler`'s clock.

A span marks one layer's work in a profiler trace: `span(name)` returns
`torch.profiler.record_function(name)` while a torch profiler records, and
otherwise one shared no-op context (no torch call, no allocation), so a
span costs one flag check when nobody profiles.  A span's parent is the
range that encloses it on the same thread: another span of the port or
the caller's own `record_function`.  The spans sit at layer boundaries
only (the trace names each kernel):

  lt.expm.block, lt.expm.vector      an expm action, the whole call
  lt.expm.project                    assemble T, expm(T), the receiver sum
  lt.eigsh.block, lt.eigsh.vector    an eigsh, the whole call
  lt.eigsh.ritz                      eigh of T, the selection, the vectors
  lt.eigsh.residuals                 `ritz_residuals`
  lt.fdtd                            an `euler_steps` loop
  lt.lanczos.prologue                the first half-iteration
  lt.lanczos.step                    each later iteration
  lt.lanczos.coeffs                  the fused step's p x p algebra
  lt.lanczos.reorth                  a CGS2 call against the stored basis
  lt.smalleig.sqrtm                  a p x p sqrtm / inv-sqrtm
  lt.tsqr                            one TSQR (T1's tree)
  lt.op.apply                        one operator product
  lt.graph.capture, lt.graph.replay  a CUDA-graph recording; one replay(k)
  lt.mesh.halo                       a halo exchange of a sharded operator
                                     (`parallel/mesh.py`), with the
                                     windowed shard's work copy
  lt.mesh.reduce, lt.mesh.gather     an all-reduce, an all-gather
  lt.mesh.any                        a flag agreed over the ranks: the
                                     all-reduce and its host read

A device op belongs to the innermost span around the host call that
launched it (the trace ties the two by their `correlation` id; a graph's
kernels to its `cudaGraphLaunch`).

The counters are always on, as `build.LAUNCHES` is:

  launches.host    kernel launches the host issued: a launch of the
                   port's kernels counts its kernels, a graph replay one
                   launch whatever it recorded
  graphs.captures, graphs.replays
  tsqr.calls       TSQRs (`ops/tsqr.py`)
  tsqr.kernel      trees T1's kernel ran (`ops/kernels/tsqr.py`
                   householder_tsqr: a CUDA float32 or float64 block,
                   p <= 16), one a TSQR, two a sharded one (the local
                   tree and the gathered R stack's); the rest ran its
                   plain version
  cgs2.calls       CGS2 passes of the block recurrence against a non-empty
                   stored basis (`methods/block_lanczos.py` _cgs2): the
                   `lt.lanczos.reorth` spans' count, kept while nobody
                   profiles too, so that cgs2.calls - cgs2.kernel says how
                   many ran the plain version in any run
  cgs2.kernel      the calls C1's kernels ran (`ops/kernels/cgs2.py` cgs2:
                   a CUDA float32 or float64 block, p <= 16), three launches
                   a call (more where the basis comes in chunks); the rest
                   ran its plain version
  lanczos.steps (the iterations after the prologue), fdtd.steps
  mesh.halo        halo exchanges; mesh.halo_bytes the bytes this rank
                   sent in them
  mesh.reduce, mesh.gather, mesh.any
                   the mesh's other collectives, one a call

One device has no mesh, so its paths make none of the `mesh` spans or
counts.

`COUNTERS` holds them since the process started; `PROFILED` the part of
them made while a torch profiler recorded, so the counts of a profiled
window are there without a snapshot around it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

COUNTERS: dict[str, int] = {}
PROFILED: dict[str, int] = {}

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records on this process now (its warm-up
    steps do not)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context marking `name` in the trace while a profiler records; a
    shared no-op otherwise."""
    return torch.profiler.record_function(name) if recording() else _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name`, and to its profiled part while a profiler
    records."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n
    if recording():
        PROFILED[name] = PROFILED.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(COUNTERS)


def profiled() -> dict[str, int]:
    """A snapshot of the counts made while a profiler recorded."""
    return dict(PROFILED)


@contextlib.contextmanager
def uncounted():
    """Leaves every counter, and its profiled part, as it found them: for
    work that records launches rather than making them."""
    saved = dict(COUNTERS), dict(PROFILED)
    try:
        yield
    finally:
        for live, kept in zip((COUNTERS, PROFILED), saved):
            live.clear()
            live.update(kept)


def reset() -> None:
    COUNTERS.clear()
    PROFILED.clear()
