"""A cell on n > 1 chips: n SPMD ranks, one card each.

`python -m portbench.run` is rank 0.  It writes the cell into a store
directory of its own (a temporary one), starts ranks 1..n-1 as `python -m
portbench.run ... --rank r --world n --store <dir>` and checks the cards
(too few: it stops them and exits 2 with no result); rank r runs on
cuda:r.  Every rank then runs `run.run_cell`, the one-chip run, with its
`Rank`, which adds only what n ranks need:

- the group: the ranks meet through a `FileStore` in the store directory,
  in one `torch.distributed` group (NCCL on the cards, gloo on the CPU),
  which the driver, built as `Driver(cfg, tr, seed, device, phases,
  group)`, and the reference get as a `Group`; every rank calls
  `request()` in lockstep, the warm-up's too;
- the barriers: `setup_s` runs from rank 0's process start to a barrier
  after every rank's warm-up, and `reference.judge(..., group)` runs on
  every rank once every rank has freed the program's state;
- the go/stop: before each request rank 0, which owns the clock, tells
  every rank to go or to stop, in one broadcast of one element, so every
  rank runs the same requests; the window ends when the last request
  begun on rank 0 returns.  A traced run profiles the same requests on
  every rank;
- the reports: each rank writes its own (requests, peak, readings, its
  trace's summary and counters, the JAX check) into the store, and rank 0
  combines them (`combine`);
- the abort policy: failure ends the run; it never hangs it.  Rank 0
  watches its ranks from a thread (`Watch`): a rank that fails (a request
  that raises ends its rank, which cannot go on without it; a rank exits
  0 only once it has reported), or a step of rank 0 that outlasts its
  limit (a rank stopped answering), ends the run.  Rank 0 then kills
  every rank and exits: in set-up with no result and code 1, as one
  process whose set-up raises does; from the window on with a result,
  `failed` 1 and `correct` false.  A rank whose rank 0 has gone exits by
  itself.  A rank that loads JAX makes rank 0 exit 3 with no result, as
  one process does: every rank's modules are in its report, and where the
  watch ends the run before the reports, rank 0 checks its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

from portbench.run import ROOT, emit, forbidden_modules, log, result_of, run_cell

# the limits of rank 0's steps, in seconds, after which the run ends as
# failed: set-up (process start to the barrier after warm-up; a
# checkout's first run builds the port's kernels in it), a request (a
# go/stop and the request; in a traced run also the profiler's start and
# its export of the trace), worked out from the warm-up's slowest request
# and never under the floor, and all after the window (the trace's
# summary, the judge and the reports)
SETUP_S = 1100.0
REQUEST_FLOOR_S = 30.0
REQUEST_FACTOR = 10.0
JUDGE_S = 300.0
EXIT_S = 30.0  # the ranks' exit after they reported
POLL_S = 0.2


@dataclasses.dataclass(frozen=True)
class Group:
    """A multi-chip cell's ranks, as its driver and reference get them:
    this rank, the world size and the `torch.distributed` process group."""

    rank: int
    size: int
    process_group: object


def request_limit(slowest: float) -> float:
    """A request's limit from the warm-up's slowest request (seconds)."""
    return max(REQUEST_FLOOR_S, REQUEST_FACTOR * slowest)


class Rank:
    """This process's place in a multi-chip run, as `run.run_cell` uses
    it: the group, the go/stop, the barriers, rank 0's watch (`Watch`,
    None on the other ranks) and the reports' exchange (`gather`)."""

    def __init__(self, rank: int, size: int, store: str, trace: bool, watch=None):
        self.rank, self.size, self.store, self.trace, self.watch = rank, size, store, trace, watch
        self.device = self._flag = None
        self.request_s = REQUEST_FLOOR_S
        self.forbidden: dict[int, list] = {}  # the other ranks' JAX check, on rank 0

    def _beat(self, step: str, seconds: float) -> None:
        if self.watch is not None:
            self.watch.beat(step, seconds)

    def join(self, device) -> Group:
        """Joins the group through the store (NCCL on cards, gloo on the
        CPU, where the ranks share the host's cores)."""
        import torch
        import torch.distributed as dist

        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // self.size))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", rank=self.rank, world_size=self.size,
            store=dist.FileStore(str(Path(self.store) / "filestore"), self.size),
            timeout=datetime.timedelta(seconds=SETUP_S))
        self.device = device
        self._flag = torch.zeros(1, dtype=torch.int32, device=device)
        if self.watch is not None:
            self.watch.device = device
        return Group(self.rank, self.size, dist.group.WORLD)

    def barrier(self) -> None:
        """Returns once every rank has called it."""
        _barrier(self.device)

    def watch_requests(self, slowest: float) -> None:
        """Set-up is over: from here a request may take request_limit(slowest)."""
        self.request_s = request_limit(slowest)
        self._beat("window start", self.request_s)

    def go(self, more: bool) -> bool:
        """Rank 0's word to every rank, one broadcast of one element: one
        more request, or stop."""
        import torch.distributed as dist

        if self.rank == 0:
            if more:
                self._beat("window", self.request_s)
            self._flag.fill_(int(more))
        dist.broadcast(self._flag, 0)
        return more if self.rank == 0 else bool(self._flag.item())

    def watched(self, request):
        """`request` with rank 0's watch told of each call (a traced run)."""
        def step():
            self._beat("window", self.request_s)
            request()

        return step

    def keep_counts(self, summary: dict) -> None:
        """This rank's counters of the traced requests, for the readers on
        rank 0 (which read the busiest rank's summary)."""
        from portbench.drivers.program import profiled_counts

        found = profiled_counts()
        if found is not None:
            summary["counts"] = found

    def window_closed(self) -> None:
        self._beat("judge", JUDGE_S)

    def gather(self, attempted, failed, summary, breakdown, readings, device_info):
        """Every rank's report into the store; rank 0 combines them into
        the run's (attempted, failed, summary, breakdown, readings,
        device_info), and the other ranks get None."""
        report = {"rank": self.rank, "attempted": attempted, "failed": failed,
                  "summary": summary, "breakdown": breakdown,
                  "readings": {k: float(v) for k, v in readings.items()},
                  "device": device_info, "forbidden": forbidden_modules()}
        if self.rank:
            path = _report_path(self.store, self.rank)
            with open(path.with_suffix(".tmp"), "w") as f:
                json.dump(report, f)
            os.replace(path.with_suffix(".tmp"), path)
            _close_group(self.device)
            return None
        _close_group(self.device)  # every rank has written its report
        reports = [report]
        for r in range(1, self.size):
            with open(_report_path(self.store, r)) as f:
                reports.append(json.load(f))
        self.forbidden = {r["rank"]: r["forbidden"] for r in reports[1:] if r["forbidden"]}
        log("ranks: " + json.dumps({
            "requests": [r["attempted"] for r in reports],
            "peak_bytes": [r["summary"]["peak_bytes"] for r in reports],
            "setup_s": [round(r["summary"]["setup_s"], 4) for r in reports],
            "busy_s": [r["summary"].get("busy_s") for r in reports],
            "window_s": [r["summary"].get("window_s") for r in reports],
            "busiest": _busiest(reports) if self.trace else None,
            "readings": [r["readings"] for r in reports]}))
        return combine(reports, self.trace)


def _busiest(reports: list) -> int:
    return max(range(len(reports)), key=lambda i: reports[i]["summary"].get("busy_s", 0.0))


def combine(reports: list, trace: bool):
    """(attempted, failed, summary, breakdown, readings, device_info) of
    the run from every rank's report, in rank order.  Every rank runs the
    same requests, so a count that differs is a failure.  The memory peak
    is the fullest rank's and each reading the worst rank's (a name a
    rank lacks reads inf).  Untraced, the window is rank 0's; traced, the
    summary and the breakdown are the busiest rank's (the most
    device-busy seconds: it sets the pace), with every rank's summary, in
    rank order, under `ranks`, and the device's busy seconds and window
    the ranks' mean.  `setup_s` is rank 0's."""
    own, n = reports[0], len(reports)
    names = {k for r in reports for k in r["readings"]}
    readings = {k: max(r["readings"].get(k, math.inf) for r in reports) for k in sorted(names)}
    failed = max(max(r["failed"] for r in reports), int(len({r["attempted"] for r in reports}) > 1))
    peak = max(r["summary"]["peak_bytes"] for r in reports)
    device_info = dict(own["device"], count=n, memory_peak_bytes=peak)
    if trace:
        busiest = reports[_busiest(reports)]
        summary = dict(busiest["summary"], ranks=[r["summary"] for r in reports])
        breakdown = busiest["breakdown"]
        device_info.update(busy_s=sum(r["summary"].get("busy_s", 0.0) for r in reports) / n,
                           window_s=sum(r["summary"].get("window_s", 0.0) for r in reports) / n)
    else:
        summary, breakdown = dict(own["summary"]), None
    summary.update(setup_s=own["summary"]["setup_s"], peak_bytes=peak)
    return own["attempted"], failed, summary, breakdown, readings, device_info


def _report_path(store, rank: int) -> Path:
    return Path(store) / f"report-{rank}.json"


def _barrier(device) -> None:
    """Returns once every rank has called it."""
    import torch
    import torch.distributed as dist

    z = torch.zeros(1, device=device)
    dist.all_reduce(z)
    z.item()


def _close_group(device) -> None:
    """The reports are in: a last barrier, then the group's end."""
    import torch.distributed as dist

    _barrier(device)
    dist.destroy_process_group()


def follow(args, t0: float) -> int:
    """Rank args.rank of args.world, started by rank 0: its run, its
    report into the store, then exit.  Any failure exits 1 at once; so
    does a rank whose rank 0 has gone."""
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True, name="portbench-orphan").start()
    try:
        with open(args.cell) as f:
            cell = json.load(f)
        run_cell(cell, args.seed, args.seconds, bool(args.trace), args.device, t0,
                 {"imports": time.perf_counter() - t0},
                 Rank(args.rank, args.world, args.store, bool(args.trace)))
    except BaseException:  # noqa: BLE001  a rank's failure is rank 0's to report
        log(f"[rank {args.rank}] failed:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)
    return 0


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(EXIT_S)
        except subprocess.TimeoutExpired:
            log(f"rank process {p.pid} did not end after it was killed")


class Watch:
    """Rank 0's guard over the other ranks, from a thread: a rank that
    fails (it exits with a code other than 0: a rank exits 0 only after
    its report and the group's last barrier), or a step of rank 0 that
    outlasts its limit, ends the run as failed (`_abort`)."""

    def __init__(self, cell: dict, trace: bool, procs: list, store: str):
        self.cell, self.trace, self.procs, self.store = cell, trace, procs, store
        self.attempted = 0
        self.device = None  # rank 0's, once set
        self._lock = threading.Lock()
        self._closed = False
        self.beat("setup", SETUP_S)
        threading.Thread(target=self._watch, daemon=True, name="portbench-watch").start()

    def beat(self, step: str, seconds: float) -> None:
        with self._lock:
            if step == "window":
                self.attempted += 1
            self._step, self._limit = step, seconds
            self._deadline = time.perf_counter() + seconds

    def close(self) -> None:
        """Every rank has reported: their exits are the run's end now."""
        with self._lock:
            self._closed = True

    def fail(self, detail: str) -> None:
        """Rank 0 raised (`detail`, its traceback): the run ends as failed.
        Where the watch is ending it already, this waits for the exit."""
        with self._lock:
            log(f"rank 0 failed:\n{detail}")
            self._abort("rank 0 raised")

    def _failed(self) -> list[str]:
        return [f"rank {r} exited with code {p.returncode}"
                for r, p in enumerate(self.procs, 1) if p.poll() not in (None, 0)]

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            with self._lock:
                if self._closed:
                    return
                late = time.perf_counter() > self._deadline
                if late or self._failed():
                    self._abort(f"rank 0's step '{self._step}' outlasted its {self._limit:g} s"
                                if late else None)

    def _abort(self, reason: str | None = None) -> None:
        """Kills every rank and exits the process: with code 3 and no result
        where rank 0 has loaded JAX or the JAX package, as one process
        does; in set-up with no result; from the window on with the run's
        result as failed.  The lock is held, so the main thread prints
        nothing."""
        reasons = self._failed() + ([reason] if reason else [])
        log(f"ranks: {'; '.join(reasons)}: the run ends as failed in {self._step}")
        _stop(self.procs)
        shutil.rmtree(self.store, ignore_errors=True)
        found = forbidden_modules()
        if found:
            log(f"the run loaded {found} (rank 0): the benchmark may not load JAX or the "
                "JAX package")
            sys.stderr.flush()
            os._exit(3)
        if self._step == "setup":
            sys.stderr.flush()
            os._exit(1)
        cuda = self.device is not None and self.device.type == "cuda"
        peak, kind = 0, "cpu"
        if cuda:
            import torch

            try:
                peak = torch.cuda.max_memory_allocated(self.device)
                kind = torch.cuda.get_device_name(self.device)
            except RuntimeError:  # the card's state is what failed: report what is known
                kind = "unknown"
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                       "count": self.cell["chips"], "memory_peak_bytes": peak}
        if self.trace:
            device_info.update(busy_s=0.0, window_s=0.0)
        attempted = max(self.attempted, 1)
        emit(result_of(self.cell, self.trace, attempted, 1, {}, None, {}, device_info))
        sys.stderr.flush()
        os._exit(0)


@dataclasses.dataclass(frozen=True)
class Started:
    """Ranks 1..n-1 as rank 0 started them, and their store directory."""

    procs: list
    store: str

    def stop(self) -> None:
        _stop(self.procs)
        shutil.rmtree(self.store, ignore_errors=True)


def start(cell: dict, args) -> Started:
    """Writes the cell into a new store directory and starts ranks
    1..n-1 there, each `python -m portbench.run ... --rank r`, its
    standard output sent to standard error.  Rank 0 starts them before it
    imports torch itself, so that the ranks' imports run side by side."""
    n = int(cell["chips"])
    store = tempfile.mkdtemp(prefix="portbench-ranks-")
    cell_path = Path(store) / "cell.json"
    with open(cell_path, "w") as f:
        json.dump(cell, f)
    common = ["--workload", cell["name"], "--cell", str(cell_path), "--seed", str(args.seed),
              "--seconds", str(args.seconds), "--trace", str(args.trace),
              "--device", args.device, "--world", str(n), "--store", store]
    procs = [subprocess.Popen([sys.executable, "-m", "portbench.run", *common, "--rank", str(r)],
                              cwd=ROOT, stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno())
             for r in range(1, n)]
    return Started(procs, store)


def lead(cell: dict, args, started: Started, t0: float, before: dict) -> int:
    """Rank 0 of a cell on cell["chips"] ranks, the others `started`: runs
    its own share, combines every rank's report and prints the result."""
    trace = bool(args.trace)
    watch = Watch(cell, trace, started.procs, started.store)
    rank = Rank(0, int(cell["chips"]), started.store, trace, watch)
    try:
        try:
            result = run_cell(cell, args.seed, args.seconds, trace, args.device, t0, before, rank)
        except Exception:  # noqa: BLE001  rank 0's own failure ends the run as failed
            watch.fail(traceback.format_exc())  # does not return
        watch.close()
        for p in started.procs:
            try:
                p.wait(EXIT_S)
            except subprocess.TimeoutExpired:
                log(f"rank process {p.pid} had not exited {EXIT_S:g} s after its report")
    finally:
        started.stop()
    found = sorted(set(forbidden_modules()).union(*rank.forbidden.values()))
    if found:
        log(f"the run loaded {found} (the other ranks: {rank.forbidden}): the benchmark may "
            "not load JAX or the JAX package")
        return 3
    emit(result)
    return 0
