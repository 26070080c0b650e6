"""The trace reduction and the per-layer readers on a synthetic profiler
trace: overlapping device intervals, idle gaps labelled by the host op
that enclosed them, the port's kernels against library ones."""

from __future__ import annotations

import pytest

from portbench.metrics import (
    device_idle_pct,
    library_share_pct,
    peak_mem_gib,
    roofline_pct,
    setup_s,
    solve_ms,
)
from portbench.trace import REQUEST, is_own, short_name, summarize

OWN = "void (anonymous namespace)::stencil_gram_kernel<float, 4>(StripArgs)"
TORCH = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(float*)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32"


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


def synthetic():
    return [
        # two requests: 0..100 us and 110..200 us
        ev("user_annotation", REQUEST, 0, 100),
        ev("user_annotation", REQUEST, 110, 90),
        ev("user_annotation", "ProfilerStep#3", 0, 200),
        # host ops on the requests' thread; one on another thread
        ev("cpu_op", "aten::item", 40, 30),
        ev("cuda_runtime", "cudaStreamSynchronize", 45, 20),
        ev("cpu_op", "aten::linalg_qr", 150, 40),
        ev("cpu_op", "other_thread_op", 0, 200, tid=2),
        # device: own 0..30 and 20..40 overlap; a copy 70..80; library
        # 120..140; own 180..210 crosses the window's end
        ev("kernel", OWN, 0, 30),
        ev("kernel", OWN, 20, 20),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 70, 10),
        ev("kernel", GEMM, 120, 20),
        ev("kernel", OWN, 180, 30),
        # outside the window: ignored
        ev("kernel", TORCH, 300, 50),
    ]


def test_summary_union_and_shares():
    s, b = summarize(synthetic())
    assert s["requests"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    # union: 0..40, 70..80, 120..140, 180..200 -> 90 us
    assert s["busy_s"] == pytest.approx(90e-6)
    assert s["own_s"] == pytest.approx((30 + 20 + 20) * 1e-6)
    assert s["library_s"] == pytest.approx((10 + 20) * 1e-6)
    ops = dict(b["device_ops"])
    assert ops["stencil_gram_kernel"] == pytest.approx(70e-6)
    assert list(ops)[0] == "stencil_gram_kernel"


def test_idle_gaps_by_enclosing_host_op():
    _, b = summarize(synthetic())
    gaps = dict(b["idle_gaps"])
    # 40..70 (midpoint 55: inside the sync, inside aten::item), 80..120
    # (100: the first request's end ... between spans: no host op), 140..180
    # (160: aten::linalg_qr)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["aten::linalg_qr"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(110e-6)
    assert "other_thread_op" not in gaps and "ProfilerStep#3" not in gaps


def test_kernel_classes_and_names():
    assert is_own(OWN) and not is_own(TORCH) and not is_own(GEMM)
    assert short_name(OWN) == "stencil_gram_kernel"
    assert short_name(TORCH).startswith("at::native::")
    assert len(short_name(GEMM)) <= 80


def test_readers():
    s, _ = summarize(synthetic())
    assert device_idle_pct.read(s) == pytest.approx(55.0)
    assert library_share_pct.read(s) == pytest.approx(100 * 30 / 100)
    assert roofline_pct.read(dict(s, least_s=45e-6)) == pytest.approx(50.0)
    assert roofline_pct.read(s) is None  # no count: nothing to read
    assert peak_mem_gib.read({"peak_bytes": 3 * 2**30}) == pytest.approx(3.0)
    assert peak_mem_gib.read({"peak_bytes": 0}) is None
    assert solve_ms.read({"window_s": 2.0, "completed": 400}) == pytest.approx(5.0)
    assert solve_ms.read({"window_s": 2.0, "completed": 0}) is None
    assert setup_s.read({"setup_s": 12.5}) == 12.5


def test_no_request_span_reads_nothing():
    s, b = summarize([ev("kernel", OWN, 0, 10)])
    assert s == {"requests": 0} and b == {"device_ops": [], "idle_gaps": []}
    assert device_idle_pct.read(s) is None and library_share_pct.read(s) is None
