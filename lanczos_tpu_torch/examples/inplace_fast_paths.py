"""The aliased fast paths: the mono Lanczos step and the one-pass FDTD
step.

    python -m lanczos_tpu_torch.examples.inplace_fast_paths [--device cpu] [--n-grid 96]

* Block Lanczos at p >= 2 takes the two-call "mono" step by default: K2
  writes q_j in place over q_{j-2}'s buffer, then K4 writes v_j = A q_j
  over v_{j-1}'s buffer and computes every Gram block in the same pass.
* The FDTD oracle's step u <- u + (dt A) u is one pass of K5, into a
  second buffer (the two buffers alternate).

Both run below and are checked against the materialized recurrence and
against each other (the expm action against the FDTD oracle).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import target_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.examples.inplace_fast_paths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-grid", type=int, default=96)
    ap.add_argument("--fdtd-steps", type=int, default=200_000)
    args = ap.parse_args(argv)
    dev = target_device(args.device)  # a RuntimeError without the card

    from lanczos_tpu_torch import (
        PallasMaxwellOperator,
        block_lanczos,
        block_lanczos_expm_action,
        fdtd_block,
    )
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
    from lanczos_tpu_torch.utils.timing import sync

    N, P, M, T_END = args.n_grid, 4, 8, 1.0
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    B = op.pack(torch.from_numpy(gaussian_matrix_B(N, op.n, P).astype(np.float32))
                .to(dev))
    print(f"Maxwell N={N}: n={op.n}, block width p={P}")
    print("mono step supported:", op.supports_stencil_gram(P))

    t0 = time.perf_counter()
    res = block_lanczos(op, B, M, fused=True)
    sync(dev)
    print(f"\nblock_lanczos m={M} (mono fused): {time.perf_counter() - t0:.3f} s")
    res_ref = block_lanczos(op, B, M, fused=False)
    # Maxwell's alphas are zero (the curl pair couples E and H only), so
    # the betas carry the comparison
    err = ((res.betas - res_ref.betas).abs().max() / res_ref.betas.abs().max()).item()
    print(f"max |beta - beta_materialized| / max |beta| = {err:.2e}")

    lc = 123
    sol = block_lanczos_expm_action(op, B, M, T_END, 0, trace_fn=op.trace_fn(lc))
    u = fdtd_block(op, B, args.fdtd_steps, T_END)  # one K5 pass a step
    ref = op.unpack(u)[:, lc].cpu().numpy()
    rel = float(np.linalg.norm(sol.cpu().numpy() - ref) / np.linalg.norm(ref))
    print(f"\nexpm action vs FDTD ({args.fdtd_steps} steps): rel err {rel:.2e}")
    if not rel < 1e-2:
        raise SystemExit(f"the expm action misses the FDTD oracle: {rel:.2e}")
    print("ok")
    return rel


if __name__ == "__main__":
    main()
