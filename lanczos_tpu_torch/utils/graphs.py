"""A fixed sequence of kernel launches captured once as a CUDA graph and
replayed: the port's counterpart of `jax.jit` over a `lax.fori_loop`.

JAX compiles a loop such as the FDTD oracle's (lanczos_tpu/methods/
fdtd.py:44-76) into one device program, so a million small steps pay no
host work between them.  Eager torch launches each step from the host; at
small states the launch costs more than the step.  `capture` records the
launches of one call of `record` on a side stream (nothing runs while it
records) and `Replay.replay(k)` launches them k times, each with one host
call.  The replayed launches are the recorded ones, on the same buffers,
in the same order, so a replay computes bit for bit what the eager loop
computes.

Rules a recorded sequence keeps: it allocates nothing, never synchronises
and never reads a device value on the host (the kernels' wrappers take
PyTorch's current stream, which is the capture stream while recording).
A `Replay` holds the tensors the graph reads and writes (`keep`) for its
life.  `build.LAUNCHES` counts what ran: recording adds nothing, and each
replay adds the recorded counts.  The port's counters (`utils/tracing.py`)
count what the host did: recording adds one capture and nothing else, and
each replay adds one replay and one host launch.  Any error in recording
or replay raises.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.utils import tracing


def split_steps(nsteps: int, chunk: int) -> tuple[int, int, int]:
    """(eager head, replays, eager tail) of an nsteps loop replayed in
    graphs of `chunk` steps: the first step eager (it loads the kernels'
    library and moves the state into the loop's own buffers), then whole
    chunks, then the rest eager.  No replay when no whole chunk remains:
    recording would cost more than it saves."""
    if chunk < 2 or chunk % 2:
        raise ValueError(f"chunk must be even and >= 2 (a ping-pong ends on "
                         f"its first buffer), got {chunk}")
    if nsteps <= 0:
        return 0, 0, 0
    replays, tail = divmod(nsteps - 1, chunk)
    return 1, replays, tail


def counted(record) -> dict[str, int]:
    """Runs `record()` and returns the launches it added to
    `build.LAUNCHES`, which it leaves as it found them, as it leaves the
    port's counters."""
    before = dict(build.LAUNCHES)
    try:
        with tracing.uncounted():
            record()
        return {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
    finally:
        build.LAUNCHES.update(before)


class Replay:
    """A recorded launch sequence (`graph`, anything with `replay()`), the
    launches it makes (`counts`) and the tensors it must outlive (`keep`)."""

    def __init__(self, graph, counts: dict[str, int], keep=()):
        self.graph, self.counts, self.keep = graph, counts, keep

    def replay(self, times: int = 1) -> None:
        with tracing.span("lt.graph.replay"):
            for _ in range(times):
                self.graph.replay()
                for name, c in self.counts.items():
                    build.LAUNCHES[name] += c
                tracing.count("graphs.replays")
                tracing.count("launches.host")


def capture(record, device: torch.device, keep=()) -> Replay:
    """The launches of one `record()` on `device` as a CUDA graph.  The
    capture runs on a side stream that first waits for the current one,
    and records nothing else from other threads (thread-local mode)."""
    with tracing.span("lt.graph.capture"):
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.device(device), torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                counts = counted(record)
            finally:
                graph.capture_end()
        current.wait_stream(side)
    tracing.count("graphs.captures")
    return Replay(graph, counts, keep)
