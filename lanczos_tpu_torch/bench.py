"""Headline benchmark: Maxwell SpMM nnz/s on the reference's largest
fixture (port of the repository's `bench.py`).

    python -m lanczos_tpu_torch.bench                 # the card, N=160
    python -m lanczos_tpu_torch.bench --device cpu --n-grid 8

The reference's hottest-kernel measurement (`ell::SpMM`,
`source/kernels/measurements/spmv_spmm.cu:345`: the N=160 Maxwell
operator, ~24.6M rows, ELL width 4, block width N_COL=4, float32), here
through the folded-plane stencil operator (`PallasMaxwellOperator.mm`,
the CUDA kernel K1) instead of a gathered ELL SpMM.

Timing: the slope of two chains of data-dependent applications
(`utils.bench_loop.slope_time_chain`, CUDA events), best of four; the
chain's anti-overflow damping is folded into the operator's weights
(`op.scaled(1e-2)`), so no extra pass over the state is timed.

Model and baseline as `bench.py:66-69`: the assembled operator's logical
nnz is 4 per row (2 curl blocks x 2 taps), so nnz = 4 n p; the baseline is
the reference's Tesla T4 run, 4 x 24.6e6 x 4 nnz in 6.17e-3 s (BASELINE.md
"spmm", N_COL=4) = 6.38e10 nnz/s.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import argparse
import json

import torch

N_GRID, P = 160, 4
REF_NNZ_PER_S = 4 * 24.6e6 * 4 / 6.17e-3  # BASELINE.md spmm, N_COL=4
SLOPES = 4


def measure(n_grid: int = N_GRID, p: int = P, device="cuda", seed: int = 0):
    """The headline measurement: {"metric", "value", "unit", "vs_baseline"}
    plus "seconds", the best per-call time of the four slopes."""
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain

    op = PallasMaxwellOperator.create(n_grid, n_grid, n_grid, dtype=torch.float32,
                                      device=device)
    damped = op.scaled(1e-2)  # ||1e-2 A|| ~ 6: a chain stays finite
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = damped.pack(torch.randn((p, op.n), generator=g).to(op.wz_t.device))
    secs = min(slope_time_chain(lambda y, a: a.mm(y), u, damped, damp=None)
               for _ in range(SLOPES))
    nnz_per_s = 4 * op.n * p / secs
    return {
        "metric": "maxwell_spmm_nnz_per_s",
        "value": nnz_per_s,
        "unit": "nnz/s (nnz x block-cols per second)",
        "vs_baseline": nnz_per_s / REF_NNZ_PER_S,
        "seconds": secs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-grid", type=int, default=N_GRID)
    ap.add_argument("--n-col", type=int, default=P)
    args = ap.parse_args(argv)
    out = measure(args.n_grid, args.n_col, args.device)
    line = {k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
