"""Convergence-vs-m curve on the reference's oracle configuration (port of
`benchmarks/convergence.py`).

    python -m lanczos_tpu_torch.benchmarks.convergence [--block] [--csv PATH]
    python -m lanczos_tpu_torch.benchmarks.convergence --device cpu --fdtd-steps 2000

The reference's published convergence experiment (`lanczos_plots.m:
166-185`, BASELINE.md): n=252 (the N=3 grid), f64, the Lanczos expm
receiver value at lc=30 against a forward-Euler FDTD run of 10^6 steps,
for m = 1..12.  The JAX package's curve (`benchmarks/results/
convergence.csv`) falls to 1.74e-9 at m=6 and 1.696e-9 from m=7 on.

Operator: `PallasMaxwellOperator` in f64, so that each FDTD step is one
launch of K5 (and each Lanczos product one of K1): the oracle's 10^6
steps are launch-bound on the card, and the flat-state `MaxwellOperator`
spends dozens of eager torch ops a step.  The JAX script runs the flat
operator; both compute the same A.  Prints each m's relative error and
the seconds the oracle and the curve took.
"""

from __future__ import annotations

import argparse
import csv
import time

import numpy as np
import torch

from lanczos_tpu_torch.benchmarks import add_device_argument, resolve_device


def curve(n_grid: int = 3, m_max: int = 12, fdtd_steps: int = 1_000_000,
          lc: int = 30, block: bool = False, device="cuda", log=print):
    """[{"m", "rel_error"}, ...] for m = 1..m_max, and the seconds of the
    FDTD oracle and of the Lanczos runs."""
    from lanczos_tpu_torch.methods.expm_action import (
        block_lanczos_expm_action,
        lanczos_expm_action,
    )
    from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B, gaussian_vector_b
    from lanczos_tpu_torch.utils.timing import sync

    device = resolve_device(device)
    N = n_grid
    op = PallasMaxwellOperator.create(N, N, N, dtype=torch.float64, device=device)
    b_np = gaussian_matrix_B(N, op.n, 4) if block else gaussian_vector_b(N, op.n)
    b = op.pack(torch.from_numpy(np.asarray(b_np, np.float64)).to(device))
    trace = op.trace_fn(lc)

    sync(device)
    t0 = time.perf_counter()
    fdtd = fdtd_block if block else fdtd_vector
    u = op.unpack(fdtd(op, b, fdtd_steps, 1.0))
    ref = (u[:, lc] if block else u[lc]).cpu().numpy()
    fdtd_seconds = time.perf_counter() - t0
    log(f"fdtd: {fdtd_steps} steps in {fdtd_seconds:.3f} s", flush=True)

    rows = []
    t0 = time.perf_counter()
    for m in range(1, m_max + 1):
        if block:
            sol = block_lanczos_expm_action(op, b, m, 1.0, lc, trace_fn=trace)
            sol = sol.cpu().numpy()
            rel = float(np.linalg.norm(sol - ref) / np.linalg.norm(ref))
        else:
            sol = float(lanczos_expm_action(op, b, m, 1.0, lc, trace_fn=trace))
            rel = abs(sol - float(ref)) / abs(float(ref))
        rows.append({"m": m, "rel_error": rel})
        log(f"m={m:2d}  rel_error={rel:.3e}", flush=True)
    lanczos_seconds = time.perf_counter() - t0
    return rows, fdtd_seconds, lanczos_seconds


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.benchmarks.convergence")
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--n-grid", type=int, default=3)
    ap.add_argument("--m-max", type=int, default=12)
    ap.add_argument("--fdtd-steps", type=int, default=1_000_000)
    # lc=30 reproduces the reference's published plateau (~1.8e-9 by m=6,
    # lanczos_plots.m:168)
    ap.add_argument("--lc", type=int, default=30)
    ap.add_argument("--csv", default=None, help="also write the curve here")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    rows, fdtd_s, lanczos_s = curve(args.n_grid, args.m_max, args.fdtd_steps,
                                    args.lc, args.block, args.device)
    print(f"seconds: fdtd {fdtd_s:.3f}, lanczos {lanczos_s:.3f}", flush=True)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["m", "rel_error"])
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return rows


if __name__ == "__main__":
    main()
