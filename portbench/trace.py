"""The traced window: a few steady requests under `torch.profiler`, and
the reduction of its Chrome trace to the summary the per-layer metrics
read.  Device time and the requests' wall time come from the one trace,
on one timeline: the requests are the harness's own spans
(`record_function(REQUEST)`), the device ops are the trace's kernel,
memcpy and memset events."""

from __future__ import annotations

import json
import os
import re
import tempfile

REQUEST = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the port's kernels live in the anonymous namespace of its one .cu file
# (torch's own anonymous-namespace kernels sit under at::native::)
_OWN = re.compile(r"^(void )?\(anonymous namespace\)::(\w+)")


def profile_requests(request, warmup: int, active: int, cuda: bool) -> list:
    """Run warmup + active requests under the profiler, each inside a
    REQUEST span; returns the trace events of the active ones."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=warmup, active=active, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(warmup + active):
                with record_function(REQUEST):
                    request()
                prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"]


def short_name(name: str) -> str:
    m = _OWN.match(name)
    if m:
        return m.group(2)
    name = name.removeprefix("void ")
    return name.split("(")[0][:80] or name[:80]


def is_own(name: str) -> bool:
    return _OWN.match(name) is not None


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host):
    """For each gap, the innermost host event (on the requests' thread)
    that covers its midpoint: a sweep over properly nested intervals."""
    host = sorted(host, key=lambda e: (e[0], -(e[1] - e[0])))
    order = sorted(range(len(gaps)), key=lambda i: (gaps[i][0] + gaps[i][1]) / 2)
    labels = [None] * len(gaps)
    stack, j = [], 0
    for i in order:
        t = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        labels[i] = stack[-1][2] if stack else "no host op"
    return labels


def summarize(events: list, top: int = 10):
    """(summary, breakdown) of a trace.  summary: window_s (the first
    request span's start to the last one's end), busy_s (the union of
    device intervals inside it), own_s and library_s (device time of the
    port's kernels and of everything else: cuBLAS, cuSOLVER, torch's
    kernels, copies), requests.  breakdown: the device ops that took most
    time, and the idle gaps' time by the host op that enclosed them."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == REQUEST]
    if not spans:
        return {"requests": 0}, {"device_ops": [], "idle_gaps": []}
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    thread = (spans[0].get("pid"), spans[0].get("tid"))
    dev, by_name = [], {}
    own = library = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        name = e.get("name", "")
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + (t - s)
        if is_own(name):
            own += t - s
        else:
            library += t - s
    busy = _union(dev)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if prev < w1:
        gaps.append((prev, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and (e.get("pid"), e.get("tid")) == thread
            and not str(e.get("name", "")).startswith("ProfilerStep")]
    idle = {}
    for (s, t), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] = idle.get(label, 0.0) + (t - s)
    us = 1e-6
    summary = {
        "requests": len(spans),
        "window_s": (w1 - w0) * us,
        "busy_s": sum(t - s for s, t in busy) * us,
        "own_s": own * us,
        "library_s": library * us,
    }

    def ranked(d):
        return [[k, v * us] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return summary, {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}
