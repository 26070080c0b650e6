"""The port's own spans in a profiler trace of the requests, and the
device time under each.

The port marks its layers with `lt.*` spans (`lanczos_tpu_torch/utils/
tracing.py`) while a profiler records.  Each device op (kernel, copy,
set) is attributed to the `lt.*` spans around the host call that launched
it: the runtime or driver call with the same `correlation` id, on that
call's thread.  A CUDA graph's kernels carry the correlation of their
`cudaGraphLaunch`, so they go to the spans around the replay.  Device
time is clipped to the requests' window as `trace.summarize` clips it,
so a share here and one there have the same denominator.  A trace with
no `lt.*` span (a program without them) has nothing to attribute.

    python -m portbench.spans --workload <cell> --seed <n> [--out FILE]

runs the cell's set-up and its traced window as `--trace 1` does, and
prints as JSON, a request: each span's calls, wall ms, device ms (of the
ops launched inside it, its children's included), self device ms (its
children's left out) and idle ms (device gaps whose midpoint falls in it
and in none of its children); the idle gaps by the innermost host op, as
the run's breakdown gives them; and the program's counters over the
traced requests.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench.trace import DEVICE_CATS, REQUEST, _union

PREFIX = "lt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no lt span)"


def _complete(e, cats) -> bool:
    return e.get("ph") == "X" and e.get("cat") in cats


def _covering(spans, times):
    """For each time, the names of the spans that cover it, outermost
    first; spans (start, end, name) properly nested, as on one thread."""
    spans = sorted(spans, key=lambda s: (s[0], -(s[1] - s[0])))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [()] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def span_summary(events: list) -> dict | None:
    """The `lt.*` spans of the traced requests: {"requests", "device_s"
    (all device time in the window), "spans": {name: {"calls", "wall_s",
    "device_s", "self_device_s", "idle_s"}}}, with the device and idle
    time under no span under NO_SPAN.  None without a request or a span."""
    requests = [e for e in events if _complete(e, ("user_annotation",))
                and e.get("name") == REQUEST]
    if not requests:
        return None
    w0 = min(float(e["ts"]) for e in requests)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in requests)
    thread = (requests[0].get("pid"), requests[0].get("tid"))
    by_thread = {}
    for e in events:
        if _complete(e, ("user_annotation",)) and str(e.get("name", "")).startswith(PREFIX):
            s = float(e["ts"])
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (s, s + float(e.get("dur", 0.0)), e["name"]))
    if not by_thread:
        return None
    stats = {}

    def entry(name):
        return stats.setdefault(name, {"calls": 0, "wall_s": 0.0, "device_s": 0.0,
                                       "self_device_s": 0.0, "idle_s": 0.0})

    for spans in by_thread.values():
        for s, t, name in spans:
            if w0 <= s <= w1:
                entry(name)["calls"] += 1
                entry(name)["wall_s"] += (t - s) * 1e-6
    # each launch's spans, on its own thread
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and _complete(e, LAUNCH_CATS):
            launches[corr] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
    device, queries = [], {}
    for e in events:
        if not _complete(e, DEVICE_CATS):
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        device.append((s, t))
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            queries.setdefault(launch[1], []).append((len(device) - 1, launch[0]))
    stacks = [()] * len(device)
    for th, qs in queries.items():
        for (k, _), stack in zip(qs, _covering(by_thread.get(th, []), [q[1] for q in qs])):
            stacks[k] = stack
    total = 0.0
    for (s, t), stack in zip(device, stacks):
        dt = (t - s) * 1e-6
        total += dt
        for name in set(stack):
            entry(name)["device_s"] += dt
        entry(stack[-1] if stack else NO_SPAN)["self_device_s"] += dt
    gaps, prev = [], w0
    for s, t in _union(device):
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if prev < w1:
        gaps.append((prev, w1))
    mids = [(s + t) / 2 for s, t in gaps]
    for (s, t), stack in zip(gaps, _covering(by_thread.get(thread, []), mids)):
        entry(stack[-1] if stack else NO_SPAN)["idle_s"] += (t - s) * 1e-6
    return {"requests": len(requests), "device_s": total, "spans": stats}


def table(summary: dict) -> list:
    """[name, calls, wall ms, device ms, self device ms, idle ms], each a
    request, the spans with the most device time first."""
    n = summary["requests"]
    rows = [[name, v["calls"] / n, v["wall_s"] * 1e3 / n, v["device_s"] * 1e3 / n,
             v["self_device_s"] * 1e3 / n, v["idle_s"] * 1e3 / n]
            for name, v in summary["spans"].items()]
    rows.sort(key=lambda r: (-r[3], -r[5]))
    return rows


def traced_spans(cell: dict, seed: int, device) -> dict:
    """Set-up, warm-up and the traced window of one cell, as a `--trace 1`
    run makes them; returns the spans' table, the idle gaps and the
    program's counters, each a traced request."""
    import torch

    from portbench import trace
    from portbench.drivers.program import profiled_counts
    from portbench.run import Phases

    cuda = device.type == "cuda"
    tr = cell["traffic"]
    driver = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    drv = driver.Driver(cell["config"], tr, seed, device,
                        Phases(lambda: torch.cuda.synchronize(device) if cuda else None))
    for _ in range(int(tr["warmup_requests"])):
        drv.request()
    before = profiled_counts() or {}
    events = trace.profile_requests(drv.request, int(tr["trace_warmup"]),
                                    int(tr["trace_requests"]), cuda)
    after = profiled_counts() or {}
    drv.free()
    summary, breakdown = trace.summarize(events)
    n = summary["requests"]
    spans = span_summary(events)
    return {
        "workload": cell["name"], "requests": n,
        "window_ms": summary["window_s"] * 1e3 / n, "busy_ms": summary["busy_s"] * 1e3 / n,
        "spans_columns": ["span", "calls", "wall_ms", "device_ms", "self_device_ms", "idle_ms"],
        "spans": table(spans) if spans else [],
        "idle_gaps_ms": [[k, v * 1e3 / n] for k, v in breakdown["idle_gaps"]],
        "counters": {k: (c - before.get(k, 0)) / n for k, c in after.items()},
    }


def main(argv=None) -> int:
    from portbench.run import keep_bytecode, load_cell

    keep_bytecode()
    ap = argparse.ArgumentParser(prog="portbench.spans", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    out = json.dumps(traced_spans(cell, args.seed, device))
    print(out, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
