"""Distributed block Lanczos on the z-slab Maxwell operator: the top-3
Ritz values of A by `block_lanczos_eigsh` on N ranks, one a device (port
of the repository's `examples/distributed_lanczos.py`).

    python -m lanczos_tpu_torch.examples.distributed_lanczos [--devices N]
    python -m lanczos_tpu_torch.examples.distributed_lanczos --device cpu --devices 2

Every product runs K1 on the rank's slab after a one-plane halo exchange,
and every Gram is one local product and one all-reduce (NCCL on the
cards, gloo with --device cpu).  --devices defaults to every card of the
machine (1 with --device cpu).  Writes a file only when given --json.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

N_GRID, P, M, K = 8, 4, 10, 3


def top_ritz(mesh, n_grid: int):
    """One rank: (top-k |Ritz| values, their residual bounds), the same on
    every rank."""
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
    from lanczos_tpu_torch.parallel import DistributedPallasMaxwell

    op = DistributedPallasMaxwell.create(n_grid, n_grid, n_grid, mesh)
    B = op.pack(torch.from_numpy(gaussian_matrix_B(n_grid, op.n, P).astype(np.float32)))
    vals, _, resid = block_lanczos_eigsh(op, B, M, K, which="LM")
    return vals, resid


def main(argv=None):
    from lanczos_tpu_torch.benchmarks import add_device_argument, write_json
    from lanczos_tpu_torch.parallel import launch

    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.examples.distributed_lanczos")
    add_device_argument(ap)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--n-grid", type=int, default=N_GRID)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device).type
    n = args.devices or (torch.cuda.device_count() if device == "cuda" else 1)
    vals, resid = launch.run(top_ritz, n, args.n_grid, device=device)[0]
    print(f"mesh: {n} rank(s) on {device}")
    print("top-3 |Ritz| :", vals.numpy())
    print("residuals    :", resid.numpy())
    out = {"devices": n, "device": device, "ritz": vals.tolist(),
           "resid": resid.tolist()}
    write_json(args.json, out)
    return out


if __name__ == "__main__":
    main()
