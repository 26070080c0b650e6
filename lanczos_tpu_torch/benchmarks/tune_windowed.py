"""The windowed-ELL plan's geometry against K8's time (port of
`benchmarks/tune_windowed.py`).

    python -m lanczos_tpu_torch.benchmarks.tune_windowed [--rows 2097152] [--p 8] [--json PATH]

Plans the synthetic SuiteSparse-style banded matrix
(`models/synthetic.py`) at every chunks-per-block cpb in {8, 16, 32} and
steps-per-group spg in {4, 8, 16, 32} (a group of cpb spg chunks shares
one window base, so the pair sets the band each group reads), and times
K8 on each plan at p block columns: the slope of the chained product
(`utils.bench_loop`), the plan's values scaled by 2^-10 so that the
chain stays finite without a separate pass.  Each row has the plan's
planes per chunk (ppc) and window (wsz), the seconds a product, nnz*col/s,
the bytes K8 moves (its planes, uint8 indices, offsets and window bases,
one read of X and one write of Y) over those seconds, and on the card
that rate against `copy_rate` of the same state.  A geometry that cannot
be planned (PlanError) is a row marked refused.  Prints the rows and the
fastest; writes a file only when given --json.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lanczos_tpu_torch.benchmarks import (
    add_device_argument,
    copy_rate,
    format_row,
    resolve_device,
    write_json,
)

CPBS, SPGS = (8, 16, 32), (4, 8, 16, 32)


def sweep(rows: int, p: int, device) -> list[dict]:
    from lanczos_tpu_torch.models.synthetic import synth_suitesparse_banded
    from lanczos_tpu_torch.ops.window_ell import PlanError, windowed_from_scipy
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain
    from lanczos_tpu_torch.utils.timing import sync

    a = synth_suitesparse_banded(rows)
    print(f"{a.shape[0]} rows, {a.nnz} nnz", flush=True)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((p, rows)).astype(np.float32))
    copy_gbps = None
    out = []
    for cpb in CPBS:
        for spg in SPGS:
            row = {"cpb": cpb, "spg": spg}
            t0 = time.perf_counter()
            try:
                A = windowed_from_scipy(a, cpb=cpb, spg=spg, reorder="none",
                                        device=device)
            except PlanError as e:
                out.append(row | {"refused": str(e)})
                print(f"cpb={cpb} spg={spg}: refused ({e})", flush=True)
                continue
            sync(device)
            row["plan_seconds"] = time.perf_counter() - t0
            row["ppc"], row["wsz"] = A.ppc, A.wsz
            Xp = A.pack(x.to(device))
            if device.type == "cuda" and copy_gbps is None:
                copy_gbps = copy_rate(Xp)
            A.planes_data.mul_(2.0 ** -10)  # exact: the chain stays finite
            sec = slope_time_chain(lambda y, A_: A_.padded_mm(y), Xp, A, damp=None)
            nbytes = (sum(t.numel() * t.element_size() for t in
                          (A.planes_data, A.planes_lidx, A.planes_off, A.wb))
                      + 2 * Xp.numel() * Xp.element_size())
            row.update(seconds=sec, nnz_per_s=a.nnz * p / sec,
                       gbps=nbytes / sec / 1e9)
            if copy_gbps is not None:
                row["pct_of_copy_bw"] = 100.0 * row["gbps"] / copy_gbps
            out.append(row)
            print(format_row(row), flush=True)
            del A, Xp
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.benchmarks.tune_windowed")
    ap.add_argument("--rows", type=int, default=2_097_152)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--json", default=None, help="also write the rows here")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    rows = sweep(args.rows, args.p, resolve_device(args.device))
    timed = [r for r in rows if "seconds" in r]
    if timed:
        print("best:", json.dumps(max(timed, key=lambda r: r["nnz_per_s"])), flush=True)
    write_json(args.json, rows)
    return rows


if __name__ == "__main__":
    main()
