"""The fused (traffic-minimal) recurrence and the compensated Gram.

    python -m lanczos_tpu_torch.examples.fused_and_compensated [--device cpu]

1. A bare block run (no reorthogonalization) on a big state routes through
   the fused recurrence: block_mix (K2) and the Grams (K3), the residual
   block never materialized.  fused=True forces it at any size,
   fused=False forces the materialized recurrence.
2. compensated=True takes every Gram from K7 (f64 sums of f32 products):
   T coefficients within O(eps_f32) of f64, from f32 storage.
3. Both forward through the eigsh front end.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import target_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.examples.fused_and_compensated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = target_device(args.device)  # a RuntimeError without the card

    from lanczos_tpu_torch import block_lanczos, block_lanczos_eigsh
    from lanczos_tpu_torch.ops.operator import MatrixOperator

    rng = np.random.default_rng(0)
    n, p, m = args.n, 4, 16
    A = rng.standard_normal((n, n))
    A = (A + A.T) / np.sqrt(n)
    op = MatrixOperator(torch.from_numpy(A.astype(np.float32)).to(dev))
    b = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32)).to(dev)

    r_fused = block_lanczos(op, b, m, fused=True)
    r_classic = block_lanczos(op, b, m, fused=False)
    d_alpha = (r_fused.alphas - r_classic.alphas).abs().max().item()
    print("fused vs materialized: max |d alpha| =", d_alpha)

    r_comp = block_lanczos(op, b, m, compensated=True)
    print("compensated alphas[0][0,0]:", r_comp.alphas[0, 0, 0].item())

    vals, _, resid = block_lanczos_eigsh(op, b, m=24, k=4, which="LA",
                                         reorth="none", fused=True)
    print("top-4 Ritz:", vals.cpu().numpy().round(5))
    print("dense     :", np.linalg.eigvalsh(A)[-4:][::-1].round(5))
    # the GOE edge needs more iterations to converge fully: the residual
    # bounds cover the remaining error
    print("residual bounds:", resid.cpu().numpy().round(6))
    return d_alpha


if __name__ == "__main__":
    main()
