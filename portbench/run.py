"""Run one cell of the benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in BENCHMARK.json, which names its
configuration (`configs/<config>.json`) and traffic
(`traffic/<traffic>.json`); the traffic names its driver
(`drivers/<driver>.py`), whose plain reference is `reference/<driver>.py`
and whose least traffic is `counts/<driver>.py`; the limits of the
comparison are `limits/<cell>.json`; each metric is read by
`metrics/<name>.py`, the name taken up to its first dot.  A cell on
`chips` > 1 runs as that many ranks, one card each (`portbench/ranks.py`);
what follows is said of one.

A run: no card, or fewer cards than the cell asks for, and it exits 2
with no result.  Set-up makes every input from the seed, builds the
port's operator and warms up the cell's own shapes.  With --trace 0 a
closed loop of requests runs for --seconds (each request waits for its
result on the host; the window ends with the last request begun inside
it), and the end-to-end metrics are printed; with --trace 1 the traffic's
`trace_requests` requests run under torch.profiler, and the per-layer
metrics are printed.  Then the program's state is freed and the plain
reference judges every answer.  The last line of standard output is the
result; clocks, power and the set-up split go to standard error before
it, and the numbers compared, each beside its limit, are the last lines
of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import trace as tracing  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package (the port's own name starts with it; names compare whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lanczos_tpu")


def log(msg: str) -> None:
    # one write, so that the lines of a multi-chip run's ranks never run together
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: dict | None = None) -> dict:
    """The cell `name`: its configuration, traffic, limits and the
    metrics it reports, found by name from BENCHMARK.json."""
    bench = benchmark if benchmark is not None else _json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    # an end-to-end metric with a `workloads` list is reported in those
    # cells alone; a per-layer metric wherever the one it moves is
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names]
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": _json(BENCH_DIR / "configs" / f"{w['config']}.json"),
        "traffic": _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


class Phases:
    """Seconds of each named set-up phase (the device synchronized at
    each phase's end, so a phase's queued work counts to it)."""

    def __init__(self, sync):
        self.seconds: dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_report() -> str | None:
    """The card's name, power limit, clocks, power draw and temperature
    as nvidia-smi reads them, or None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def least_seconds(counts: dict, dtype: str, kind: str) -> float | None:
    """The least time of one request on the card: the larger of its
    least bytes over the card's bandwidth and its operations over the
    card's peak for the dtype (`peaks.json`); None for a card not there."""
    peaks = _json(BENCH_DIR / "peaks.json").get(kind)
    if peaks is None or dtype not in peaks["flops_per_s"]:
        return None
    return max(counts["bytes"] / peaks["bytes_per_s"],
               counts["flops"] / peaks["flops_per_s"][dtype])


def reader(name: str):
    """The reader of metric `name`: `metrics/<stem>.py`, the stem being
    the name up to its first dot, so that `solve_ms.eigsh` is read as
    `solve_ms` is, in the cells that report it."""
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")


def cell_module(cell: dict, part: str):
    """The cell's `part` (drivers, reference or counts): the module of its
    traffic's driver, `portbench.<part>.<driver>`, or the one the cell
    names under `modules` (the harness's own test cells)."""
    default = f"portbench.{part}.{cell['traffic']['driver']}"
    return importlib.import_module(cell.get("modules", {}).get(part, default))


def read_metrics(specs: list, summary: dict) -> dict:
    out = {}
    for spec in specs:
        value = reader(spec["name"]).read(summary)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0, before: dict | None = None, rank=None) -> dict | None:
    """Set-up, the window and the judge of one run; returns the result.
    `before`: seconds of the set-up phases that ran before this call
    (else all of it since t0 counts as imports).  `rank`: this process's
    `ranks.Rank` in a multi-chip run, which adds the group, the go/stop,
    the barriers and its abort policy (a request that raises ends the
    run); there the result is rank 0's, combined from every rank's, and
    the other ranks return None."""
    import torch

    t_before = time.perf_counter() - t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", rank.rank if rank else 0)
    lead = rank is None or rank.rank == 0
    say = log if lead else (lambda msg: log(f"[rank {rank.rank}] {msg}"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def go(more: bool) -> bool:
        return rank.go(more) if rank else more

    cfg, tr = cell["config"], cell["traffic"]
    driver_mod = cell_module(cell, "drivers")
    reference = cell_module(cell, "reference")
    counts = cell_module(cell, "counts")
    phases = Phases(sync)
    phases.seconds.update(before or {"imports": t_before})
    with phases("cuda_init"):
        if cuda:
            torch.cuda.init()
            torch.cuda.set_device(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    group = ()
    if rank:
        with phases("join_group"):
            group = (rank.join(dev),)
    drv = driver_mod.Driver(cfg, tr, seed, dev, phases, *group)
    slowest = 0.0
    with phases("warmup"):
        for _ in range(int(tr["warmup_requests"])):
            t = time.perf_counter()
            drv.request()
            slowest = max(slowest, time.perf_counter() - t)
    if rank:
        with phases("barrier"):
            rank.barrier()
        rank.watch_requests(slowest)
    setup_s = time.perf_counter() - t0  # the harness's own report below is not set-up
    say("setup split (s): " + json.dumps({k: round(v, 4) for k, v in phases.seconds.items()}))
    card = card_report() if cuda and lead else None
    if card:
        log(f"card before the window: {card}")

    attempted = failed = 0
    summary = {"setup_s": setup_s}
    breakdown = None
    start = end = time.perf_counter()
    if not trace:
        deadline = start + seconds
        while go(time.perf_counter() < deadline):
            attempted += 1
            try:
                drv.request()
            except Exception as exc:  # a request that raises fails; the run goes on to judge
                if rank:  # the other ranks cannot go on without this one's share
                    raise
                failed += 1
                log(f"request {attempted} failed: {exc!r}")
                break
            finally:
                end = time.perf_counter()
        summary.update(window_s=end - start, completed=attempted - failed)
    else:
        warm, active = int(tr["trace_warmup"]), int(tr["trace_requests"])
        attempted = warm + active
        request = rank.watched(drv.request) if rank else drv.request
        try:
            events = tracing.profile_requests(request, warm, active, cuda)
            traced, breakdown = tracing.summarize(events)
            # a metric reads the summary and, under "events", the raw trace
            summary.update(traced, events=events)
        except Exception as exc:
            if rank:
                raise
            failed += 1
            log(f"traced window failed: {exc!r}")
        if rank:
            rank.keep_counts(summary)
    if rank:
        rank.window_closed()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary["peak_bytes"] = peak
    card = card_report() if cuda and lead else None
    if card:
        log(f"card after the window: {card}")
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if trace and summary.get("requests"):
        least = least_seconds(counts.request(cfg, tr), cfg["dtype"], kind)
        if least is not None:
            summary["least_s"] = least * summary["requests"]

    drv.free()
    records, kept = drv.records, drv.kept
    del drv
    if cuda:
        torch.cuda.empty_cache()
    if rank:
        rank.barrier()  # every rank has freed the program's state
    t_judge = time.perf_counter()
    readings = reference.judge(cfg, tr, seed, dev, records, kept, *group) if records else {}
    say(f"judge: {len(records)} answers in {time.perf_counter() - t_judge:.2f} s")
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=summary.get("busy_s", 0.0),
                           window_s=summary.get("window_s", 0.0))
    run = (attempted, failed, summary, breakdown, readings, device_info)
    if rank:
        run = rank.gather(*run)
        if run is None:
            return None
    return result_of(cell, trace, *run)


def result_of(cell: dict, trace: bool, attempted: int, failed: int, summary: dict,
              breakdown: dict | None, readings: dict, device_info: dict) -> dict:
    """The result line of a run: `correct` (no request failed, one was
    attempted, and every reading within its limit; a missing one reads
    inf), the cell's metrics read from the summary, and `checks` last."""
    checks = {name: {"value": readings.get(name, math.inf), "limit": limit}
              for name, limit in cell["limits"].items()}
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    specs = cell["per_layer"] if trace else cell["end_to_end"]
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": read_metrics(specs, summary), "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The result as the last line of standard output, then each number
    compared beside its limit as the last lines of standard error."""
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}")


def keep_bytecode() -> None:
    """Keep the bytecode of every module this run imports in a fixed
    directory of the checkout, `_pycache/`.  Where the environment forbids
    writing it (PYTHONDONTWRITEBYTECODE) and the installed packages ship
    none, every run would compile torch's sources anew: seconds of set-up
    that swing with the host's load.  So only a checkout's first
    run compiles them, as only its first run builds the port's kernels."""
    sys.pycache_prefix = str(ROOT / "_pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    keep_bytecode()
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cell", help="a cell as load_cell gives it, in a JSON file, in place of "
                    "the one BENCHMARK.json names (the harness's tests; rank 0 hands its "
                    "ranks the cell so)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the harness's tests, through the port's plain kernel versions")
    ap.add_argument("--rank", type=int, help="this rank of a multi-chip run (set by rank 0)")
    ap.add_argument("--world", type=int, help="the ranks of a multi-chip run (set by rank 0)")
    ap.add_argument("--store", help="a multi-chip run's store directory (set by rank 0)")
    args = ap.parse_args(argv)
    if args.rank is not None:
        from portbench import ranks

        return ranks.follow(args, T0)
    cell = _json(Path(args.cell)) if args.cell else load_cell(args.workload)
    t = time.perf_counter()
    before = {"python_start": t - T0}
    started = None
    if cell["chips"] > 1:
        from portbench import ranks

        started = ranks.start(cell, args)
        before["start_ranks"] = time.perf_counter() - t
        t = time.perf_counter()

    import torch

    before["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA device(s); found {cards}")
            if started:
                started.stop()
            return 2
    before["card_check"] = time.perf_counter() - t
    if started:
        return ranks.lead(cell, args, started, T0, before)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device=args.device,
                      before=before)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may not load JAX or the JAX package")
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
