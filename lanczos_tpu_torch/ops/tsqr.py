"""Tall-skinny QR (TSQR), port of `lanczos_tpu/ops/tsqr.py`.

The block-Lanczos variant of BASELINE.json config 3 normalizes each Krylov
block by QR instead of the reference's sqrtm(W^T W)
(`block_lanczos.hpp:28-34`): it never squares the condition number.

The tree is T1's (`ops/kernels/tsqr.py`): Householder QRs of row tiles,
then of their stacked R factors, level by level, with the explicit
factors pushed back down.  It takes the block-major (p, n) state as it
is and gives q block-major.  Signs are normalized (diag(R) >= 0), so the
factorization is unique and does not depend on the tiling.
`householder_tsqr` picks the route: T1's kernel on a CUDA float32 or
float64 state with p <= 16, its plain torch version elsewhere.
`tsqr_sharded` runs the same tree on a state split over the ranks of a
mesh: the local tree on each rank, then one all-gather of the p x p R
factors (O(p^2) traffic, not O(n)).
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import tsqr as t1
from lanczos_tpu_torch.utils import tracing


def _rows(x, want_q, plan=None):
    tracing.count("tsqr.calls")
    with tracing.span("lt.tsqr"):
        return t1.householder_tsqr(x, want_q, plan)


def tsqr_rows(x: torch.Tensor, want_q: bool = True):
    """QR of the block-major (p, n) x, the transpose of a tall block.

    Returns (q, r): q (p, n) block-major with orthonormal rows (None when
    want_q is False: the R alone costs one pass over x, not two), r (p, p)
    upper triangular with non-negative diagonal, x.T = q.T @ r."""
    return _rows(x, want_q)


def tsqr(a: torch.Tensor, n_chunks: int | None = None):
    """QR of a tall-skinny (n, p) matrix by the same tree, in leaf tiles
    of ceil(n / n_chunks) rows if n_chunks is given (`tsqr_plan`).

    Returns (q, r): q (n, p) with orthonormal columns, r (p, p) upper
    triangular with non-negative diagonal, a = q @ r."""
    n, p = a.shape
    plan = None if n_chunks is None else t1.tsqr_plan(n, p, a.element_size(), n_chunks)
    q, r = _rows(a.T.contiguous(), True, plan)
    return q.T, r


def tsqr_sharded(x: torch.Tensor, mesh, want_q: bool = True):
    """TSQR of a BLOCK-MAJOR (p, n) state split over the ranks of `mesh`
    along its last axis, x being this rank's (p, n_local) part: the local
    tree, an all-gather of the (p, p) R factors, a QR of their (size p, p)
    stack (every rank computes the same one) and a local recombine.

    Returns (q, r): q (p, n_local) this rank's part of the orthonormal
    rows (None when want_q is False), r (p, p) the same upper triangle on
    every rank with a non-negative diagonal, x.T = q.T @ r over the global
    state.  Zero columns of x (the slabs' pads) stay zero in q up to
    rounding."""
    tracing.count("tsqr.calls")
    with tracing.span("lt.tsqr"):
        p = x.shape[0]
        ql, rl = t1.householder_tsqr(x, want_q)
        stack = mesh.all_gather(rl).reshape(mesh.size * p, p)
        q2, r = t1.householder_tsqr(stack.T.contiguous(), want_q)
        if not want_q:
            return None, r
        return q2[:, mesh.rank * p:(mesh.rank + 1) * p] @ ql, r
