"""SpMM and eigsh of a general assembled sparse matrix through the
windowed-ELL kernel (K8).

    python -m lanczos_tpu_torch.examples.windowed_general_matrix [matrix.mtx] [--device cpu]

The analogue of the reference's `change_order(4)` + `ell::SpMM` pipeline
(`source/kernels/spmv_spmm.hpp:106-199`): the host planner (the C++
engine, `lanczos_tpu_torch.native`) packs the matrix into 128-lane planes
over banded windows once, and K8 streams them.  Without a file it builds
a synthetic banded SPD matrix of 200,000 rows.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lanczos_tpu_torch.ops.operator import target_device


def synthetic(n: int):
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    offs = [0, 1, -1, 7, -7, 64, -64]
    a = sp.diags([rng.standard_normal(n - abs(o)) * 0.3 for o in offs], offs).tocsr()
    a = (0.5 * (a + a.T)).tolil()
    a.setdiag(np.asarray(abs(a).sum(axis=1)).ravel() + 1.0)
    return a.tocsr()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lanczos_tpu_torch.examples.windowed_general_matrix")
    ap.add_argument("matrix", nargs="?", default=None, help=".mtx / .npz file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=200_000)
    args = ap.parse_args(argv)
    dev = target_device(args.device)  # a RuntimeError without the card

    from lanczos_tpu_torch import (
        PaddedWindowedOperator,
        block_lanczos_eigsh,
        load_sparse,
        windowed_from_scipy,
    )

    a_sp = load_sparse(args.matrix) if args.matrix else synthetic(args.rows)
    # RCM reordering applies when the band would overflow the window cap;
    # the operator then represents P A P^T (same spectrum)
    a = windowed_from_scipy(a_sp.astype(np.float32), device=dev)
    print(f"{a_sp.shape[0]} rows, {a_sp.nnz} nnz -> {a.ppc} planes/chunk, "
          f"window {a.wsz}")

    x = np.random.default_rng(1).standard_normal(a_sp.shape[0])
    y = a.unpermute(a.mv(a.permute(torch.from_numpy(x).float().to(dev))))
    want = a_sp @ x
    err = float(np.linalg.norm(y.cpu().numpy() - want) / np.linalg.norm(want))
    print(f"SpMV vs scipy rel err: {err:.2e}")

    op = PaddedWindowedOperator(a)
    b = a.pack(torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, a_sp.shape[0])).astype(np.float32)).to(dev))
    vals, _, resid = block_lanczos_eigsh(op, b, m=20, k=5, which="LA",
                                         reorth="periodic", eig_backend="newton")
    print("top-5 Ritz values:", vals.cpu().numpy())
    print("residual bounds  :", resid.cpu().numpy())
    return err


if __name__ == "__main__":
    main()
