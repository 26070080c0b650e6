"""The harness on n > 1 ranks (`portbench/ranks.py`), driven as the
benchmark is run (`python -m portbench.run`, rank 0 in a process of its
own) with a test-only SPMD probe (`portbench/tests/spmd/`): on the CPU
over gloo at world sizes 2 and 4, and, marked cuda, on four cards over
NCCL (`python -m pytest portbench/tests -m cuda -q -s`).

A sound run is correct, with every rank running the same requests, the
device count n and the fullest rank's memory peak; a traced run reads
the busiest rank and keeps every rank's summary; a rank that raises,
dies or hangs in the window ends the run as not correct within a bounded
time, and one that fails in set-up or loads JAX ends it with no result
(rank 0's JAX too where the watch ends the run), each leaving no process
behind; one rank that leaves out its exchange makes the run not correct;
and the probe's control, the reference in bfloat16 run as the program
through `--cell`, is not correct."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import uuid

import pytest

from portbench.ranks import REQUEST_FACTOR, REQUEST_FLOOR_S, combine, request_limit
from portbench.run import ROOT, load_cell, reader

SEED = 2**33 + 21  # seeds may take more than 32 bits
RUN_LIMIT_S = 180  # one run of the probe, from its start to its exit
# a failing run ends long before its window would: a hang at the request
# limit's floor (the probe's warm-up takes milliseconds)
FAILURE_WINDOW_S = REQUEST_FLOOR_S + 45.0
LIMIT = 1e-5  # answer_rel_err: float32 reads ~1e-7; a dropped halo ~1e-2


def probe_cell(world: int, *faults: dict, steps: int = 3, rows: int = 256,
               driver: str = "portbench.tests.spmd.driver") -> dict:
    """A cell of the probe on `world` ranks, with BENCHMARK.json's solve_ms
    and setup_s and the per-layer metrics that move solve_ms, `faults`
    planted; its name is new each time, so that its processes can be
    found.  `driver`: the module run as the program."""
    base = load_cell("maxwell160-fdtd")
    cfg = {"kind": "spmd-probe", "rows": rows, "halo": 2, "dtype": "float32",
           "faults": list(faults)}
    return {
        "name": f"spmd-probe-{uuid.uuid4().hex[:12]}", "chips": world, "config": cfg,
        "traffic": {"driver": "spmd", "p": 4, "steps": steps, "pool": 3, "warmup_requests": 1,
                    "trace_warmup": 1, "trace_requests": 2},
        "limits": {"answer_rel_err": LIMIT},
        "end_to_end": base["end_to_end"], "per_layer": base["per_layer"],
        "modules": {"drivers": driver,
                    "reference": "portbench.tests.spmd.reference",
                    "counts": "portbench.tests.spmd.counts"},
    }


def fault(rank: int, kind: str, request: int) -> dict:
    return {"rank": rank, "kind": kind, "request": request}


def processes_of(name: str) -> list[int]:
    """Live processes whose command line holds the cell's name."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if name.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            continue
    return found


def run_probe(tmp_path, cell: dict, device="cpu", trace=0, seconds=0.5) -> dict:
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(cell))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell["name"], "--cell", str(path),
         "--seed", str(SEED), "--seconds", str(seconds), "--trace", str(trace),
         "--device", device],
        cwd=ROOT, capture_output=True, text=True, timeout=RUN_LIMIT_S)
    lines = proc.stdout.strip().splitlines()
    ranks = [ln for ln in proc.stderr.splitlines() if ln.startswith("ranks: {")]
    return {"rc": proc.returncode, "result": json.loads(lines[-1]) if lines else None,
            "stderr": proc.stderr, "seconds": time.perf_counter() - t,
            "ranks": json.loads(ranks[-1][len("ranks: "):]) if ranks else None,
            "left": processes_of(cell["name"])}


def check_sound(out: dict, world: int) -> dict:
    res = out["result"]
    assert out["rc"] == 0 and res is not None, out["stderr"][-4000:]
    assert res["correct"], (res["checks"], out["stderr"][-4000:])
    assert res["failed"] == 0 and res["attempted"] >= 1 and list(res)[-1] == "checks"
    assert res["device"]["count"] == world
    info = out["ranks"]
    assert info["requests"] == [res["attempted"]] * world
    assert res["device"]["memory_peak_bytes"] == max(info["peak_bytes"])
    assert not out["left"]
    return res


@pytest.mark.parametrize("world,steps", [(2, 3), (4, 3), (4, 0)])
def test_sound_run_is_correct(tmp_path, world, steps):
    """steps 0: requests that do no work, so solve_ms is the go/stop's."""
    res = check_sound(run_probe(tmp_path, probe_cell(world, steps=steps)), world)
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("world", [2, 4])
def test_traced_run_keeps_every_rank(tmp_path, world):
    out = run_probe(tmp_path, probe_cell(world), trace=1)
    res = check_sound(out, world)
    assert out["ranks"]["requests"] == [3] * world  # trace_warmup + trace_requests
    assert {"busy_s", "window_s"} <= set(res["device"])
    # the counters reach rank 0's readers with the busiest rank's summary
    assert res["metrics"]["host_launches"]["value"] == 0.0


def _report(rank, busy, peak, err, attempted=3):
    return {"rank": rank, "attempted": attempted, "failed": 0,
            "readings": {"answer_rel_err": err} if err is not None else {},
            "summary": {"setup_s": 10.0 + rank, "requests": 2, "window_s": 1.0, "busy_s": busy,
                        "own_s": busy / 2, "library_s": busy / 2, "peak_bytes": peak,
                        "counts": {"launches.host": 10 * rank}},
            "breakdown": {"device_ops": [[f"kernel_{rank}", busy]], "idle_gaps": []},
            "device": {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak,
                       "busy_s": busy, "window_s": 1.0}}


def test_combine_reads_the_busiest_rank():
    reports = [_report(0, 0.2, 5, 1e-7), _report(1, 0.9, 7, 3e-6), _report(2, 0.5, 9, 2e-7)]
    attempted, failed, summary, breakdown, readings, device = combine(reports, True)
    assert (attempted, failed) == (3, 0)
    assert breakdown["device_ops"][0][0] == "kernel_1"
    assert reader("device_idle_pct").read(summary) == pytest.approx(10.0)
    assert reader("host_launches").read(summary) == 5.0  # rank 1's 10 over 2 requests
    assert summary["peak_bytes"] == 9 and summary["setup_s"] == 10.0
    assert [s["busy_s"] for s in summary["ranks"]] == [0.2, 0.9, 0.5]
    assert readings == {"answer_rel_err": 3e-6}
    assert device["count"] == 3 and device["memory_peak_bytes"] == 9
    assert device["busy_s"] == pytest.approx(1.6 / 3) and device["window_s"] == 1.0


def test_combine_untraced_and_a_missing_reading():
    reports = [_report(0, 0.0, 5, 1e-7), _report(1, 0.0, 7, None)]
    reports[0]["summary"].update(window_s=2.0, completed=40)
    attempted, failed, summary, breakdown, readings, device = combine(reports, False)
    assert breakdown is None and "ranks" not in summary and failed == 0
    assert reader("solve_ms").read(summary) == pytest.approx(50.0)
    assert summary["peak_bytes"] == 7 and readings == {"answer_rel_err": math.inf}
    assert device["count"] == 2 and device["memory_peak_bytes"] == 7


def test_combine_fails_ranks_that_ran_apart():
    """Every rank runs the same requests: counts that differ, or a rank's
    own failure, fail the run."""
    assert combine([_report(0, 0.0, 5, 1e-7), _report(1, 0.0, 5, 1e-7, attempted=4)],
                   False)[1] == 1
    reports = [_report(0, 0.0, 5, 1e-7), _report(1, 0.0, 5, 1e-7)]
    reports[1]["failed"] = 1
    assert combine(reports, False)[1] == 1


def test_request_limit_follows_the_warm_up():
    assert request_limit(0.001) == REQUEST_FLOOR_S
    assert request_limit(12.0) == 12.0 * REQUEST_FACTOR > REQUEST_FLOOR_S


@pytest.mark.parametrize("kind", ["raise", "exit", "hang"])
def test_failing_rank_ends_the_run(tmp_path, kind):
    """Rank 2 fails in its third request (the window's second): the run
    ends as not correct well inside its window, and leaves no process."""
    out = run_probe(tmp_path, probe_cell(4, fault(2, kind, 3)), seconds=FAILURE_WINDOW_S)
    res = out["result"]
    assert out["rc"] == 0 and res is not None, out["stderr"][-4000:]
    assert not res["correct"] and res["failed"] >= 1 and res["device"]["count"] == 4
    assert out["seconds"] < FAILURE_WINDOW_S
    assert not out["left"]


@pytest.mark.parametrize("rank", [0, 3])
def test_failure_in_set_up_gives_no_result(tmp_path, rank):
    """A rank that raises in its warm-up request: exit 1 and no result, as
    one process whose set-up raises."""
    out = run_probe(tmp_path, probe_cell(4, fault(rank, "raise", 1)))
    assert out["rc"] == 1 and out["result"] is None and not out["left"]
    assert "a planted fault" in out["stderr"]


def test_rank_that_loads_jax_gives_no_result(tmp_path):
    out = run_probe(tmp_path, probe_cell(2, fault(1, "jax", 1)))
    assert out["rc"] == 3 and out["result"] is None
    assert "'jax'" in out["stderr"] and not out["left"]


def test_rank_0_that_loads_jax_gives_no_result_when_the_watch_ends_the_run(tmp_path):
    """Rank 0 loads JAX in its warm-up, then rank 2 hangs in the window:
    the watch ends the run, and rank 0's JAX still means no result."""
    out = run_probe(tmp_path, probe_cell(4, fault(0, "jax", 1), fault(2, "hang", 3)),
                    seconds=FAILURE_WINDOW_S)
    assert out["rc"] == 3 and out["result"] is None, out["stderr"][-4000:]
    assert "outlasted" in out["stderr"] and "'jax'" in out["stderr"]
    assert out["seconds"] < FAILURE_WINDOW_S and not out["left"]


def test_rank_without_its_exchange_is_not_correct(tmp_path):
    out = run_probe(tmp_path, probe_cell(4, fault(1, "no_exchange", 1)))
    res = out["result"]
    assert out["rc"] == 0 and res["failed"] == 0 and not res["correct"]
    assert res["checks"]["answer_rel_err"]["value"] > 100 * LIMIT
    assert not out["left"]


@pytest.mark.parametrize("world", [2, 4])
def test_control_run_as_the_program_is_not_correct(tmp_path, world):
    """The route of a multi-chip cell's control: the reference in the
    precision below the configuration's, a driver run as the program
    through `--cell`, judged over the ranks as a run judges the program."""
    out = run_probe(tmp_path, probe_cell(world, driver="portbench.tests.spmd.control"))
    res = out["result"]
    assert out["rc"] == 0 and res is not None, out["stderr"][-4000:]
    assert res["failed"] == 0 and not res["correct"] and not out["left"]
    assert res["checks"]["answer_rel_err"]["value"] > 100 * LIMIT


def test_too_few_cards_no_result(tmp_path):
    """More ranks than cards: exit 2, no result, the started ranks gone."""
    import torch

    world = max(2, torch.cuda.device_count() + 1)
    out = run_probe(tmp_path, probe_cell(world), device="cuda")
    assert out["rc"] == 2 and out["result"] is None and not out["left"]


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "raise", "hang", "no_exchange", "control"])
def test_on_four_cards(four_cards, tmp_path, kind):
    """The probe at 2,097,152 rows a rank over NCCL; `control`: the
    probe's control run as the program."""
    faults = [fault(2, kind, 1 if kind == "no_exchange" else 3)] if kind in (
        "raise", "hang", "no_exchange") else []
    driver = "portbench.tests.spmd.control" if kind == "control" else "portbench.tests.spmd.driver"
    cell = probe_cell(4, *faults, rows=2**21, driver=driver)
    out = run_probe(tmp_path, cell, device="cuda",
                    seconds=FAILURE_WINDOW_S if kind in ("raise", "hang") else 2.0)
    res = out["result"]
    print(f"\nfour cards, {kind}: {out['seconds']:.2f} s, result {json.dumps(res)}")
    assert not out["left"]
    if kind is None:
        check_sound(out, 4)
        assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    else:
        assert out["rc"] == 0 and not res["correct"]
        assert out["seconds"] < FAILURE_WINDOW_S


@pytest.mark.cuda
def test_traced_on_four_cards(four_cards, tmp_path):
    out = run_probe(tmp_path, probe_cell(4, rows=2**21), device="cuda", trace=1)
    res = check_sound(out, 4)
    info = out["ranks"]
    b = info["busiest"]
    assert info["busy_s"][b] == max(info["busy_s"]) > 0
    assert res["metrics"]["device_idle_pct"]["value"] == pytest.approx(
        100 * (1 - info["busy_s"][b] / info["window_s"][b]))
    assert res["device"]["busy_s"] == pytest.approx(sum(info["busy_s"]) / 4)
    print(f"\nfour cards traced: {json.dumps(info)}\n{json.dumps(res)}")


@pytest.mark.cuda
def test_go_stop_cost_on_four_cards(four_cards, tmp_path):
    """Requests that do no work: solve_ms is the go/stop broadcast's cost
    a request (with the loop's own), which has to stay well under 1% of
    the ~1 s request of a deployment that needs four cards."""
    out = run_probe(tmp_path, probe_cell(4, steps=0), device="cuda", seconds=5.0)
    res = check_sound(out, 4)
    ms = res["metrics"]["solve_ms"]["value"]
    print(f"\ngo/stop on four cards: {ms * 1e3:.2f} us a request over {res['attempted']} requests")
    assert ms < 10.0
