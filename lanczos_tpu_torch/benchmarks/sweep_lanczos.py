"""Whole-algorithm sweep (port of `benchmarks/sweep_lanczos.py`, the
counterpart of the reference's `tensor_core_unfinished_work/
measure_lanczos.cu`).

    python -m lanczos_tpu_torch.benchmarks.sweep_lanczos [--vector] [--n-col 4]
    python -m lanczos_tpu_torch.benchmarks.sweep_lanczos --sweep-ncol [--operator windowed]

Sweeps the Maxwell grid N geometrically (x1.25), times the whole (block-)
Lanczos run at two iteration counts m1 < m2 and reports the per-iteration
seconds as the slope (t(m2) - t(m1)) / (m2 - m1), m2 escalating until the
difference clears 25 ms.  t(m) is the best of three runs, each ended by a
synchronise of the device.  Each row carries the reference's analytic
per-iteration byte/flop model (`iteration_model`,
`measure_lanczos.cu:268-300`) as GB/s and GFLOPS columns, and `route`:
"mono" where the fused recurrence takes the two-call step (K2 + K4: p from
2 to 8, f32), "3-call" where it takes K2 + K1 + K3 (p = 1, and p = 9..18,
beyond K4's instantiations), "materialized" off the fused path.

--sweep-ncol fixes the size and sweeps the block width N_COL = 2..18, with
the reference's per-vector speedup of block over single-vector Lanczos,
(1 / ((t / N_COL) / t_vl) - 1) * 100 % (`lanczos_plots.m:141-150`); the
single-vector t_vl is measured again in the same window for every row.
--operator windowed runs it on the synthetic assembled matrix
(`models/synthetic.py`) through K8 at N_COL 8 and 16.

A row faster than one read and write of its block state at the same-window
copy rate can only be a timing that did not resolve: the run fails.
"""

from __future__ import annotations

import argparse
import csv
import time

import numpy as np
import torch

from lanczos_tpu_torch.benchmarks import (
    add_device_argument,
    copy_rate,
    format_row,
    resolve_device,
)

NCOLS = [2, 4, 6, 8, 10, 12, 14, 16, 18]


def iteration_model(n: int, p: int, width: int = 4, itemsize: int = 4):
    """Analytic per-iteration (bytes, flops) of one block-Lanczos iteration
    in the reference's accounting (`measure_lanczos.cu:268-300`): the SpMM
    (ELL data + index + vectors), the two Gram products, the two tall x
    small updates and the basis copy.  At p == 1 it is the vector-Lanczos
    model (:101-127)."""
    nv = n * itemsize  # one n-vector
    spmm_bytes = n * width * (itemsize + 4) + 2 * p * nv
    gram_bytes = 2 * (2 * p * nv)  # mm_tt + mm_tt2 (T read twice, ref model)
    ts_bytes = 3 * (3 * p * nv)  # Q1=W*inv, W-=Q0 b, W-=Q1 a (r,r,w)
    flops = 2.0 * n * width * p + 12.0 * n * p * p
    return spmm_bytes + gram_bytes + ts_bytes, flops


def _time_once(run, device, trials: int = 3) -> float:
    from lanczos_tpu_torch.utils.timing import sync

    best = float("inf")
    for _ in range(trials):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def iteration_slope(run, m1: int, m2: int, device, m_max: int = 25_600):
    """(seconds per iteration, m2 used): (t(m2) - t(m1)) / (m2 - m1), m2
    growing x4 until the difference clears 25 ms of host jitter."""
    while True:
        times = {}
        for m in (m1, m2):
            run(m)  # warm-up
            times[m] = _time_once(lambda: run(m), device)
        delta = times[m2] - times[m1]
        if delta >= 25e-3 or m2 >= m_max:
            return max(delta, 1e-12) / (m2 - m1), m2
        m2 = min(m2 * 4, m_max)


def check_roofline(row: dict, copy_gbps: float) -> None:
    """An iteration cannot finish faster than one read and write of its
    block state at the same-window copy rate; a row that does would be a
    timing that did not resolve, so the run fails."""
    floor = 2.0 * row["n"] * 4 * max(row["p"], 1) / (1.20 * copy_gbps * 1e9)
    if row["seconds_per_iter"] < floor:
        raise SystemExit(
            f"ROOFLINE VIOLATION: {row['seconds_per_iter']:.3g} s/iter is below "
            f"the one-state-pass floor {floor:.3g} s at the same-window copy "
            f"rate {copy_gbps:.0f} GB/s for row {row}: the timing did not resolve"
        )


def route(op, p: int, fused: bool) -> str:
    if not fused:
        return "materialized"
    gram = getattr(op, "supports_stencil_gram", None)
    return "mono" if p >= 2 and gram is not None and gram(p) else "3-call"


def _maxwell(N, device):
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator

    return PallasMaxwellOperator.create(N, N, N, device=device)


def _block_start(N, n, p, pack, device):
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B, gaussian_vector_b

    b = gaussian_vector_b(N, n) if p == 1 else gaussian_matrix_B(N, n, p)
    return pack(torch.from_numpy(np.asarray(b, np.float32)).to(device))


def _runner(op, b, reorth, trace_fn, block: bool):
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos

    if block:
        return lambda m: block_lanczos(op, b, m, reorth=reorth, trace_fn=trace_fn)
    return lambda m: vector_lanczos(op, b, m, reorth=reorth, trace_fn=trace_fn)


def _fused(b, reorth) -> bool:
    from lanczos_tpu_torch.methods.block_lanczos import FUSED_GATE_BYTES

    return reorth == "none" and b.numel() * b.element_size() >= FUSED_GATE_BYTES


def _open_csv(path, fields):
    if not path:
        return None, None
    f = open(path, "w", newline="")
    w = csv.DictWriter(f, fieldnames=fields)
    w.writeheader()
    return f, w


def sweep_ncol(args, device) -> list[dict]:
    """Fixed size, block width N_COL swept, with the per-vector speedup."""
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import (
        PaddedWindowedOperator,
        windowed_from_scipy,
    )

    if args.operator == "windowed":
        N = args.n_max or 0
        n = N ** 3 if N else 10_485_760
        base = windowed_from_scipy(synth_suitesparse_banded(n), reorder="none",
                                   device=device)
        op = PaddedWindowedOperator(base)
        rng = np.random.default_rng(0)

        def start(p):
            x = rng.standard_normal((p, n)).astype(np.float32)
            return base.pack(torch.from_numpy(x).to(device))

        trace_fn = lambda q: q[:, 0].clone()  # noqa: E731
        vec_trace = lambda q: q[0].clone()  # noqa: E731
        p_list = [8, 16]
        bv = start(1)[0]
    else:
        N = args.n_max or 160
        op = _maxwell(N, device)
        n = op.n
        start = lambda p: _block_start(N, n, p, op.pack, device)  # noqa: E731
        trace_fn = vec_trace = op.trace_fn(0)
        p_list = NCOLS
        bv = start(1)
    run_v = _runner(op, bv, args.reorth, vec_trace, block=False)
    t_vl, m2v = iteration_slope(run_v, args.m1, args.m2, device)
    print(f"single-vector: {t_vl:.6g} s/iter (m2={m2v})", flush=True)
    copy_gbps = copy_rate(bv) if device.type == "cuda" else None

    rows = [{"n": n, "n_grid": N, "p": 1, "m1": args.m1, "m2": m2v,
             "route": route(op, 1, _fused(bv[None], args.reorth)),
             "seconds_per_iter": t_vl, "gbps_model": 0.0, "gflops_model": 0.0,
             "per_vector_speedup_pct": 0.0}]
    f, w = _open_csv(args.csv, list(rows[0]))
    if w:
        w.writerow(rows[0])
    for p in p_list:
        b = start(p)
        sec, m2u = iteration_slope(_runner(op, b, args.reorth, trace_fn, True),
                                   args.m1, args.m2, device)
        # the single-vector time again, in this row's window
        t_vl_now, _ = iteration_slope(run_v, args.m1, args.m2, device)
        bts, fl = iteration_model(n, p)
        row = {"n": n, "n_grid": N, "p": p, "m1": args.m1, "m2": m2u,
               "route": route(op, p, _fused(b, args.reorth)),
               "seconds_per_iter": sec, "gbps_model": bts / sec / 1e9,
               "gflops_model": fl / sec / 1e9,
               "per_vector_speedup_pct": (1.0 / ((sec / p) / t_vl_now) - 1.0) * 100.0}
        if copy_gbps:
            check_roofline(row, copy_gbps)
        rows.append(row)
        if w:
            w.writerow(row)
            f.flush()
        print(format_row(row), flush=True)
    if f:
        f.close()
        print(f"wrote {args.csv}")
    return rows


def sweep_n(args, device) -> list[dict]:
    """The geometric N sweep at one block width (or single-vector)."""
    n_max = args.n_max or (16 if device.type == "cpu" else 200)
    sizes, x = [], float(args.n_min)
    while round(x) <= n_max:
        if not sizes or round(x) != sizes[-1]:
            sizes.append(int(round(x)))
        x *= args.factor
    p = args.n_col if args.block else 1
    rows, f, w = [], None, None
    for N in sizes:
        if args.operator == "pallas":
            op = _maxwell(N, device)
            pack, trace_fn = op.pack, op.trace_fn(0)
        else:
            from lanczos_tpu_torch.models.maxwell import MaxwellOperator

            op = MaxwellOperator.create(N, N, N, device=device)
            pack, trace_fn = (lambda x: x), None
        b = _block_start(N, op.n, p, pack, device)
        sec, m2u = iteration_slope(_runner(op, b, args.reorth, trace_fn, args.block),
                                   args.m1, args.m2, device)
        bts, fl = iteration_model(op.n, p)
        fused = _fused(b if args.block else b[None], args.reorth)
        row = {"n": op.n, "n_grid": N, "p": p, "m1": args.m1, "m2": m2u,
               "route": route(op, p, fused), "seconds_per_iter": sec,
               "gbps_model": bts / sec / 1e9, "gflops_model": fl / sec / 1e9}
        if device.type == "cuda":
            check_roofline(row, copy_rate(b))
        rows.append(row)
        if args.csv and w is None:
            f, w = _open_csv(args.csv, list(row))
        if w:
            w.writerow(row)
            f.flush()
        print(format_row(row), flush=True)
    if f:
        f.close()
        print(f"wrote {args.csv}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.benchmarks.sweep_lanczos")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--block", action="store_true", default=True)
    g.add_argument("--vector", dest="block", action="store_false")
    ap.add_argument("--n-col", type=int, default=4)
    ap.add_argument("--n-min", type=int, default=10)
    ap.add_argument("--n-max", type=int, default=None,
                    help="largest grid (default 200 on the card, 16 on the CPU; "
                         "--sweep-ncol: the fixed grid, default 160)")
    ap.add_argument("--factor", type=float, default=1.25)
    ap.add_argument("--m1", type=int, default=2)
    ap.add_argument("--m2", type=int, default=12)
    ap.add_argument("--reorth", default="none")
    ap.add_argument("--operator", default="pallas",
                    choices=["pallas", "stencil", "windowed"])
    ap.add_argument("--csv", default=None, help="also write the rows here")
    ap.add_argument("--sweep-ncol", action="store_true",
                    help="fixed size, block width N_COL 2..18 and the "
                         "single-vector run, with the reference's per-vector "
                         "speedup (lanczos_plots.m:141-150)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.operator == "windowed" and not args.sweep_ncol:
        ap.error("--operator windowed runs with --sweep-ncol")
    if args.sweep_ncol:
        return sweep_ncol(args, device)
    return sweep_n(args, device)


if __name__ == "__main__":
    main()
