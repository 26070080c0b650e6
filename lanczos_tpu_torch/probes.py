"""Timing probes of the port on one CUDA card, beyond `chip_smoke.py`.

    python -m lanczos_tpu_torch.probes

At the slice of `chip_smoke.py` (Maxwell N=160, m=6, p=4, receiver 20,
f32), prints the card's name and power limit, then:

1. sqrtm + inverse sqrtm of a p x p SPD matrix per eig backend (jacobi,
   newton, lax) at p = 4, 8, 16: host ms per call after a synchronise,
   mean of 10 calls after 3 warm-up calls.  This algebra is launch-bound,
   so the host clock is its cost.
2. `block_lanczos_expm_action` on the Maxwell fixture per eig backend, fused and materialized (--no-fused): ms per iteration (CUDA
   events around one run; after a warm-up run of each, three rounds that
   visit every configuration in turn, so drift of the host's speed falls
   on all of them alike), the median and each round, and peak device
   memory.
3. A `torch.profiler` trace of one default run (fused, jacobi): device
   time per kernel, and the device's idle share, 1 - device / wall, with
   the wall time of an untraced run (the profiler slows the host).
"""

from __future__ import annotations

import subprocess
import time

import torch

from lanczos_tpu_torch.methods.expm_action import block_lanczos_expm_action
from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm

BACKENDS = ("jacobi", "newton", "lax")
N, M, P, LC = 160, 6, 4, 20
ROUNDS = 3


def probe_sqrtm(dev) -> None:
    for p in (4, 8, 16):
        g = torch.Generator(device=dev).manual_seed(p)
        a = torch.randn((p, p), generator=g, device=dev)
        a = a @ a.T + p * torch.eye(p, device=dev)
        for be in BACKENDS:
            for _ in range(3):
                sqrtm_invsqrtm(a, backend=be)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                sqrtm_invsqrtm(a, backend=be)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / 10 * 1e3
            print(f"sqrtm p={p} {be}: {ms:.3f} ms/call (host clock)", flush=True)


def probe_slice(op, b, m, tf) -> None:
    dev = b.device
    configs = [(be, fused) for be in BACKENDS for fused in (True, False)]

    def once(be, fused):
        return block_lanczos_expm_action(op, b, m, 1.0, 0, trace_fn=tf,
                                         eig_backend=be, fused=fused)

    ms, peak, sols = {c: [] for c in configs}, {}, {}
    for c in configs:
        once(*c)
    for _ in range(ROUNDS):
        for c in configs:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sols[c] = once(*c)
            end.record()
            torch.cuda.synchronize(dev)
            ms[c].append(start.elapsed_time(end) / m)
            peak[c] = torch.cuda.max_memory_allocated(dev) / 2**30
    for be, fused in configs:
        t = ms[be, fused]
        print(f"slice m={m} eig={be} fused={fused}: median "
              f"{sorted(t)[len(t) // 2]:.3f} ms/iteration (rounds "
              f"{', '.join(f'{x:.3f}' for x in t)}), peak "
              f"{peak[be, fused]:.2f} GiB, solution "
              f"{sols[be, fused].tolist()}", flush=True)


def probe_profile(op, b, m, tf) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = b.device

    def timed_run():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        block_lanczos_expm_action(op, b, m, 1.0, 0, trace_fn=tf)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    timed_run()
    wall_ms = timed_run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = timed_run()
    ka = prof.key_averages()
    # kernel rows only: an aten row repeats its kernels' device time
    device_ms = sum(e.self_device_time_total for e in ka
                    if e.device_type != DeviceType.CPU) / 1e3
    print(ka.table(sort_by="self_device_time_total", row_limit=14,
                   max_name_column_width=48))
    if device_ms > 0:
        print(f"profile m={m}: device {device_ms:.3f} ms, wall {wall_ms:.3f} ms "
              f"untraced ({traced_ms:.3f} traced), device idle "
              f"{1 - device_ms / wall_ms:.1%}", flush=True)
    else:
        print(f"profile m={m}: wall {wall_ms:.3f} ms, device time not measured "
              "(the trace holds no device events)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time the CUDA card: none is available")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    probe_sqrtm(dev)
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    b_np = gaussian_matrix_B(N, op.n, P).astype("float32")
    b = op.pack(torch.from_numpy(b_np).to(dev))
    del b_np
    tf = op.trace_fn(LC)
    probe_slice(op, b, M, tf)
    probe_profile(op, b, M, tf)


if __name__ == "__main__":
    main()
