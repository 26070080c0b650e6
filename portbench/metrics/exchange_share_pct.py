"""exchange_share_pct: the share of the traced requests' device time in
ops launched inside the port's `lt.mesh.*` spans (its collectives: the
halo exchange with the windowed shard's work copy, the all-reduces, the
all-gathers and the agreed flags; NCCL's kernels and copies), attributed
by correlation id (`portbench/spans.py`), on the busiest rank of a cell
on several cards.  The `lt.mesh.*` spans do not nest in one another.
0.0 where the program has spans but none of the mesh's (one card);
nothing to read where it has no spans."""

from portbench.spans import span_summary

PREFIX = "lt.mesh."


def read(s: dict):
    spans = span_summary(s.get("events") or [])
    if spans is None or not spans["device_s"]:
        return None
    mesh = sum(v["device_s"] for name, v in spans["spans"].items() if name.startswith(PREFIX))
    return 100.0 * mesh / spans["device_s"]
