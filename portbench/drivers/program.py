"""What the program counts of itself, for the per-layer metrics of source
`program_counter`: the port's counters (`lanczos_tpu_torch/utils/
tracing.py`) made while a torch profiler recorded, which in a run are
those of the traced requests.  A program without such counters reads
nothing."""

from __future__ import annotations


def profiled_counts() -> dict | None:
    """The port's counts made while a profiler recorded; None for a
    program that has no counters."""
    try:
        from lanczos_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.profiled()


def per_request(summary: dict, name: str):
    """Counter `name` a traced request, 0.0 where it did not move; None
    with no traced request or no counters.  The counts are this process's,
    or those the summary carries (a rank's, read on rank 0)."""
    if not summary.get("requests"):
        return None
    counts = summary["counts"] if "counts" in summary else profiled_counts()
    if counts is None:
        return None
    return counts.get(name, 0) / summary["requests"]
