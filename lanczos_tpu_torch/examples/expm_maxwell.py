"""Matrix-exponential action on the 3-D Maxwell operator, the reference's
headline pipeline (`test_lanczos.cu`), on the folded-plane stencil
operator (K1/K4 in Lanczos, K5 in the FDTD oracle) with an FDTD check.

    python -m lanczos_tpu_torch.examples.expm_maxwell [--device cpu] [--n-grid 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import target_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.examples.expm_maxwell")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-grid", type=int, default=10)
    ap.add_argument("--fdtd-steps", type=int, default=100_000)
    args = ap.parse_args(argv)
    dev = target_device(args.device)  # a RuntimeError without the card

    from lanczos_tpu_torch import (
        PallasMaxwellOperator,
        block_lanczos_expm_action,
        fdtd_block,
    )
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B

    N = args.n_grid
    op = PallasMaxwellOperator.create(N, N, N, device=dev)
    p, m, lc = 4, 8, 30
    B = op.pack(torch.from_numpy(
        gaussian_matrix_B(N, op.n, p).astype(np.float32)).to(dev))
    sol = block_lanczos_expm_action(op, B, m, 1.0, 0, trace_fn=op.trace_fn(lc))
    sol = sol.cpu().numpy()
    print(f"[expm(A) B]_{lc} via {m}-step block Lanczos:", sol)

    ref = op.unpack(fdtd_block(op, B, args.fdtd_steps, 1.0))[:, lc].cpu().numpy()
    rel = float(np.linalg.norm(sol - ref) / np.linalg.norm(ref))
    print("FDTD oracle       :", ref)
    print("relative error    :", rel)
    return rel


if __name__ == "__main__":
    main()
