"""Weak scaling of the z-slab operator (port of the repository's
`benchmarks/weak_scaling.py`).

    python -m lanczos_tpu_torch.benchmarks.weak_scaling [--devices 1 2 4] [--json PATH]
    python -m lanczos_tpu_torch.benchmarks.weak_scaling --device cpu --devices 1 2

Holds each rank's slab FIXED (`--z-per-device` planes of an `--n-xy`
square) while the mesh grows, and reports the seconds of one SpMM (the
slope of chained products, `utils.bench_loop`, on rank 0; every rank runs
the same chain), the efficiency t(1)/t(d) and the nnz rate.  A product
moves one z-plane to each neighbour, independent of the slab's volume, so
ideal weak scaling is flat.

Each mesh size d runs d ranks, one a device (`parallel/launch.py`).  On
the cards a size larger than the machine's card count is skipped with a
message, never run as several ranks on one card; the default sizes are
the powers of two up to the card count.  With --device cpu the ranks are
gloo processes on the host: that checks the harness and the collective
schedule, not a card's bandwidth.  Writes a file only when given --json.
"""

from __future__ import annotations

import argparse

import torch

from lanczos_tpu_torch.benchmarks import (
    add_device_argument,
    format_row,
    write_json,
)


def spmm_seconds(mesh, n_xy: int, z_per_device: int, p: int, seed: int):
    """One rank: (n, seconds of one damped SpMM on the slab)."""
    from lanczos_tpu_torch.parallel import DistributedPallasMaxwell
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain

    op = DistributedPallasMaxwell.create(n_xy, n_xy, z_per_device * mesh.size, mesh)
    damped = op.scaled(1e-2)  # a chain stays finite
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = damped.pack(torch.randn((p, op.n), generator=g))
    return op.n, slope_time_chain(lambda y, a: a.mm(y), u, damped, damp=None)


def main(argv=None):
    from lanczos_tpu_torch.parallel import launch
    from lanczos_tpu_torch.parallel.mesh import available_devices

    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.benchmarks.weak_scaling")
    add_device_argument(ap)
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="mesh sizes (default: the powers of two up to the "
                         "card count; 1 and 2 with --device cpu)")
    ap.add_argument("--n-xy", type=int, default=16, help="x/y grid extent")
    ap.add_argument("--z-per-device", type=int, default=16,
                    help="interior z planes a rank (weak scaling)")
    ap.add_argument("--p", type=int, default=4, help="block columns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device).type
    avail = available_devices(device)
    if device == "cuda" and not avail:
        raise RuntimeError("weak_scaling: CUDA is not available (pass --device cpu)")
    sizes = args.devices or [d for d in (1, 2, 4, 8, 16, 32)
                             if d <= (avail or 2)]

    rows, t1 = [], None
    for d in sizes:
        if avail is not None and d > avail:
            print(f"skip d={d}: needs {d} cards, this machine has {avail}",
                  flush=True)
            continue
        n, sec = launch.run(spmm_seconds, d, args.n_xy, args.z_per_device,
                            args.p, args.seed, device=device)[0]
        t1 = sec if t1 is None else t1
        row = {"devices": d, "n": n, "nz": args.z_per_device * d, "p": args.p,
               "seconds_per_spmm": sec, "efficiency": t1 / sec,
               "nnz_per_s_total": 4 * n * args.p / sec, "device": device}
        rows.append(row)
        print(format_row(row), flush=True)
    write_json(args.json, rows)
    return rows


if __name__ == "__main__":
    main()
