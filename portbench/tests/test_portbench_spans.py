"""The port's spans and counters as the benchmark reads them
(`portbench/spans.py`, `drivers/program.py` and the readers of
`tsqr_share_pct`, `host_launches` and `graph_captures`): on a synthetic
trace, device ops attributed by correlation id to the `lt.*` spans around
their launch, a graph's kernels to the span around its `cudaGraphLaunch`;
the summary and the accepted metrics the same with and without `lt.*`
events; on the CPU, each cell's traced run through the harness."""

from __future__ import annotations

import sys
import time

import pytest

from portbench import spans
from portbench.metrics import (
    device_idle_pct,
    graph_captures,
    host_launches,
    library_share_pct,
    peak_mem_gib,
    roofline_pct,
    tsqr_share_pct,
)
from portbench.run import run_cell
from portbench.tests.cells import tiny_cell
from portbench.tests.test_portbench_trace import synthetic
from portbench.trace import REQUEST, summarize

GEQR = "void geqr2_gmem_domino<float, float, 9>(int, int, float*)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32"
FDTD = "void (anonymous namespace)::fdtd_step_kernel<float, 4>(StripArgs)"


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def traced():
    """Two requests, 0..100 and 110..200 us.  The first: an eigsh with a
    TSQR (10..30) whose launch at 12 runs geqr2 at 15..45, after it, in
    a step (40..90), a gemm launched at 42 and a graph replay (60..70)
    whose one launch at 62 runs two kernels.  The second: a kernel
    launched outside any span, and one whose launch is not in the trace."""
    return [
        ev("user_annotation", REQUEST, 0, 100),
        ev("user_annotation", REQUEST, 110, 90),
        ev("user_annotation", "lt.eigsh.block", 5, 90),
        ev("user_annotation", "lt.tsqr", 10, 20),
        ev("cpu_op", "aten::linalg_qr", 11, 18),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        ev("user_annotation", "lt.lanczos.step", 40, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 2, corr=2),
        ev("user_annotation", "lt.graph.replay", 60, 10),
        ev("cuda_runtime", "cudaGraphLaunch", 62, 3, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=5),
        # a span on another thread takes no launch of this one
        ev("user_annotation", "lt.tsqr", 0, 200, tid=2),
        ev("kernel", GEQR, 15, 30, corr=1),
        ev("kernel", GEMM, 50, 10, corr=2),
        ev("kernel", FDTD, 62, 4, corr=3),
        ev("kernel", FDTD, 66, 4, corr=3),
        ev("kernel", GEMM, 125, 10, corr=5),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 140, 10, corr=4),
    ]


def test_attribution_by_correlation():
    s = spans.span_summary(traced())
    assert s["requests"] == 2
    assert s["device_s"] == pytest.approx((30 + 10 + 8 + 10 + 10) * 1e-6)
    st = s["spans"]
    assert st["lt.tsqr"]["device_s"] == pytest.approx(30e-6)  # geqr2 runs past the span
    assert st["lt.tsqr"]["calls"] == 2  # one on each thread
    assert st["lt.lanczos.step"]["device_s"] == pytest.approx(18e-6)
    assert st["lt.lanczos.step"]["self_device_s"] == pytest.approx(10e-6)
    assert st["lt.eigsh.block"]["device_s"] == pytest.approx(48e-6)
    assert st["lt.eigsh.block"]["self_device_s"] == 0.0
    assert st[spans.NO_SPAN]["self_device_s"] == pytest.approx(20e-6)
    assert st["lt.lanczos.step"]["wall_s"] == pytest.approx(50e-6)


def test_graph_kernels_go_to_the_span_around_the_graph_launch():
    st = spans.span_summary(traced())["spans"]
    assert st["lt.graph.replay"]["device_s"] == pytest.approx(8e-6)
    assert st["lt.graph.replay"]["self_device_s"] == pytest.approx(8e-6)


def test_idle_by_innermost_span():
    st = spans.span_summary(traced())["spans"]
    # gaps of the window 0..200 and their midpoints' innermost span:
    # 0..15 the eigsh, 45..50 the step, 60..62 the replay, 70..125,
    # 135..140 and 150..200 none
    assert st["lt.eigsh.block"]["idle_s"] == pytest.approx(15e-6)
    assert st["lt.lanczos.step"]["idle_s"] == pytest.approx(5e-6)
    assert st["lt.graph.replay"]["idle_s"] == pytest.approx(2e-6)
    assert st[spans.NO_SPAN]["idle_s"] == pytest.approx((55 + 5 + 50) * 1e-6)
    rows = spans.table(spans.span_summary(traced()))
    assert rows[0][0] == "lt.eigsh.block" and rows[0][1] == 0.5


def test_no_span_or_no_request_reads_nothing():
    assert spans.span_summary(synthetic()) is None
    assert spans.span_summary([ev("user_annotation", "lt.tsqr", 0, 10)]) is None
    assert tsqr_share_pct.read({}) is None
    assert tsqr_share_pct.read({"events": synthetic()}) is None


def test_tsqr_share():
    assert tsqr_share_pct.read({"events": traced()}) == pytest.approx(100 * 30 / 68)


def test_accepted_metrics_read_the_same_with_lt_events():
    """The port's spans change the trace by user_annotation events alone:
    every summary number and every accepted metric reads what it read."""
    plain = synthetic()
    marked = plain + [ev("user_annotation", "lt.eigsh.block", 2, 96),
                      ev("user_annotation", "lt.tsqr", 145, 45),
                      ev("user_annotation", "lt.lanczos.step", 30, 60)]
    s0, b0 = summarize(plain)
    s1, b1 = summarize(marked)
    assert s0 == s1 and b0["device_ops"] == b1["device_ops"]
    for metric in (device_idle_pct, library_share_pct, peak_mem_gib):
        assert metric.read(dict(s1, peak_bytes=2**30)) == metric.read(dict(s0, peak_bytes=2**30))
    assert roofline_pct.read(dict(s1, least_s=45e-6)) == roofline_pct.read(dict(s0, least_s=45e-6))
    # a gap's label is now the innermost host op, a span where no op is
    gaps = dict(b1["idle_gaps"])
    assert gaps["aten::linalg_qr"] == pytest.approx(40e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)


@pytest.fixture
def counters():
    from lanczos_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_counter_readers(counters):
    from torch.profiler import ProfilerActivity, profile

    counters.count("launches.host", 100)  # set-up: not recorded
    with profile(activities=[ProfilerActivity.CPU]):
        counters.count("launches.host", 44)
    assert host_launches.read({"requests": 2}) == 22.0
    assert graph_captures.read({"requests": 2}) == 0.0  # did not move: 0, not None
    assert host_launches.read({}) is None and graph_captures.read({"requests": 0}) is None


def test_counter_readers_on_a_program_without_counters(monkeypatch):
    import lanczos_tpu_torch.utils

    monkeypatch.delattr(lanczos_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "lanczos_tpu_torch.utils.tracing", None)
    assert host_launches.read({"requests": 2}) is None
    assert graph_captures.read({"requests": 2}) is None


def short_trace(name):
    """The tiny cell with one warm-up and two traced requests."""
    cell = tiny_cell(name)
    cell["traffic"].update(warmup_requests=1, trace_warmup=1, trace_requests=2)
    return cell


@pytest.mark.parametrize("name,want", [
    ("maxwell160-block-expm", {"lanczos.steps": 5}),
    ("maxwell160-fdtd", {"fdtd.steps": 500}),
    # TSQR: the start block, 11 steps twice (the cleanup's re-QR), beta_m's R
    ("banded10m-block-eigsh", {"lanczos.steps": 11, "tsqr.calls": 24}),
])
def test_traced_spans_on_the_cpu(counters, name, want):
    import torch

    out = spans.traced_spans(short_trace(name), 2**33 + 17, torch.device("cpu"))
    rows = {r[0]: r for r in out["spans"]}
    for key, n in want.items():
        assert out["counters"][key] == n
    if name == "maxwell160-fdtd":
        assert rows["lt.fdtd"][1] == 1
    else:
        assert rows["lt.lanczos.step"][1] == want["lanczos.steps"]
    if "tsqr.calls" in want:
        assert rows["lt.tsqr"][1] == want["tsqr.calls"]


@pytest.mark.parametrize("name", ["maxwell160-block-expm", "maxwell160-fdtd",
                                  "banded10m-block-eigsh"])
def test_traced_run_reports_the_counters(counters, name):
    res = run_cell(short_trace(name), 2**33 + 17, 0.3, True, device="cpu",
                   t0=time.perf_counter())
    assert res["correct"], res["checks"]
    got = res["metrics"]
    if name == "banded10m-block-eigsh":
        # no kernel launches on the CPU, and no device time to share
        assert got["host_launches.eigsh"]["value"] == 0.0
        assert "tsqr_share_pct.eigsh" not in got
    else:
        assert got["host_launches"]["value"] == 0.0
        assert got["graph_captures"]["value"] == 0.0
