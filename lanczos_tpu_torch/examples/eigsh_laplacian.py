"""Top-k eigenvalues of a 2-D Laplacian (BASELINE.json config 1).

    python -m lanczos_tpu_torch.examples.eigsh_laplacian [--device cpu] [--grid 100]

Block Lanczos (p=4, TSQR, full reorthogonalization) on the 10k x 10k
(100 x 100 grid) 2-D Laplacian in f64, against scipy's eigsh.  The top of
this spectrum is tightly clustered (spacing ~1e-3) with a degenerate
pair: a block of width 4 resolves the multiplicity one vector cannot.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import target_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.examples.eigsh_laplacian")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, default=100)
    ap.add_argument("--m", type=int, default=150)
    args = ap.parse_args(argv)
    dev = target_device(args.device)  # a RuntimeError without the card

    from scipy.sparse.linalg import eigsh

    from lanczos_tpu_torch import block_lanczos_eigsh, ell_from_scipy
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy

    a_sp = laplacian_2d_scipy(args.grid, args.grid)
    a = ell_from_scipy(a_sp, dtype=torch.float64, device=dev)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, a_sp.shape[0]))).to(dev)
    vals, _, resid = block_lanczos_eigsh(
        a, B, m=args.m, k=5, which="LA", reorth="full", normalize="qr",
        compute_vectors=True)
    vals = vals.cpu().numpy()
    ref = np.sort(eigsh(a_sp, k=5, which="LA")[0])[::-1]
    err = float(np.max(np.abs(vals - ref) / ref))
    print("top-5 Ritz values:", vals)
    print("residual bounds  :", resid.cpu().numpy())
    print("scipy eigsh      :", ref)
    print("max rel err      :", err)
    return err


if __name__ == "__main__":
    main()
