"""Benchmark timing and analytic roofline models (port of
`lanczos_tpu/utils/timing.py`).

The reference's protocol (`source/kernels/measurements/mm_tt.cu:206-225`):
best of `tests` timed batches of `reps` calls, the first call excluded.
On a CUDA tensor a batch is timed by CUDA events on the tensor's device,
recorded on its current stream around the batch; on the CPU by
`time.perf_counter` around it (CPU ops return when they are done).  The
byte/flop models stay with the caller; `roofline` turns them into
achieved GB/s and GFLOPS.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


def _tensors(objs):
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, torch.nn.Module):
            yield from obj.buffers()
            yield from obj.parameters()
        elif isinstance(obj, (list, tuple)):
            yield from _tensors(obj)


def find_device(*objs) -> torch.device:
    """The device of the first tensor among objs (tensors, modules with
    buffers or parameters, or sequences of those); the CPU if none."""
    return next((t.device for t in _tensors(objs)), torch.device("cpu"))


class Timer:
    """Seconds of the work issued between `start()` and `stop()` on one
    device: CUDA events on its current stream, or the host clock on the
    CPU.  `stop()` waits for the device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            with torch.cuda.device(self.device):
                self._begin = torch.cuda.Event(enable_timing=True)
                self._end = torch.cuda.Event(enable_timing=True)

    def scope(self):
        """Enter the device, so that the calls timed issue to its stream."""
        return torch.cuda.device(self.device) if self.cuda else contextlib.nullcontext()

    def start(self) -> None:
        if self.cuda:
            self._begin.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            return self._begin.elapsed_time(self._end) * 1e-3
        return time.perf_counter() - self._t0


def sync(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_best(fn, *args, tests: int = 5, reps: int = 10) -> float:
    """Best per-call seconds over `tests` timed batches of `reps` calls of
    fn(*args); the first call is a warm-up outside the timing."""
    out = fn(*args)
    timer = Timer(find_device(out, args))
    best = float("inf")
    with timer.scope():
        sync(timer.device)
        for _ in range(tests):
            timer.start()
            for _ in range(reps):
                out = fn(*args)
            best = min(best, timer.stop() / reps)
    return best


def benchmark_chained(fn, x0, *extra, tests: int = 5, reps: int = 10) -> float:
    """Best per-call seconds for a self-map y = fn(y, *extra), timed as a
    data-dependent chain of `reps` calls from x0 (each call consumes the
    previous call's output, as a Lanczos or FDTD step does)."""
    y = fn(x0, *extra)
    timer = Timer(find_device(x0, extra))
    best = float("inf")
    with timer.scope():
        sync(timer.device)
        for _ in range(tests):
            y = x0
            timer.start()
            for _ in range(reps):
                y = fn(y, *extra)
            best = min(best, timer.stop() / reps)
    return best


@dataclass
class Roofline:
    seconds: float
    bytes_moved: float
    flops: float

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9


def roofline(seconds: float, bytes_moved: float, flops: float) -> Roofline:
    """Analytic effective-bandwidth model in the reference's style
    (`measurements/spmv_spmm.cu:419-446`): the caller supplies the per-op
    byte/flop formula; this reports achieved GB/s and GFLOPS."""
    return Roofline(seconds, bytes_moved, flops)
