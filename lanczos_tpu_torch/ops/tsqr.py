"""Tall-skinny QR (TSQR), port of `lanczos_tpu/ops/tsqr.py`.

The block-Lanczos variant of BASELINE.json config 3 normalizes each Krylov
block by QR instead of the reference's sqrtm(W^T W)
(`block_lanczos.hpp:28-34`): it never squares the condition number.

Two-level tree: split the n rows into c chunks, QR each chunk (one batched
`torch.linalg.qr`), QR the stacked (c*p, p) R factors, and recombine.
Signs are normalized (diag(R) >= 0), so the factorization is unique and
does not depend on the chunking.  `tsqr_sharded` runs the same tree on a
state split over the ranks of a mesh: the local tree on each rank, then
one all-gather of the p x p R factors (O(p^2) traffic, not O(n)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fix_signs(q, r):
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, 1.0, d).to(r.dtype)
    return q * d[..., None, :], r * d[..., :, None]


def tsqr(a: torch.Tensor, n_chunks: int = 8):
    """QR of a tall-skinny (n, p) matrix by a two-level reduction tree.

    Returns (q, r): q (n, p) with orthonormal columns, r (p, p) upper
    triangular with non-negative diagonal, a = q @ r."""
    n, p = a.shape
    c = max(1, min(n_chunks, n // max(p, 1)))
    rows = -(-n // c) * c
    blocks = F.pad(a, (0, 0, 0, rows - n)).reshape(c, rows // c, p)
    q1, r1 = torch.linalg.qr(blocks, mode="reduced")
    q2, r = torch.linalg.qr(r1.reshape(c * p, p), mode="reduced")
    q = torch.bmm(q1, q2.reshape(c, p, p)).reshape(rows, p)[:n]
    return _fix_signs(q, r)


def tsqr_sharded(x: torch.Tensor, mesh):
    """TSQR of a BLOCK-MAJOR (p, n) state split over the ranks of `mesh`
    along its last axis, x being this rank's (p, n_local) part: the local
    tree, an all-gather of the (p, p) R factors, a QR of their (size p, p)
    stack (every rank computes the same one) and a local recombine.

    Returns (q, r): q (p, n_local) this rank's part of the orthonormal
    rows, r (p, p) the same upper triangle on every rank with a
    non-negative diagonal, x.T = q.T @ r over the global state.  Zero
    columns of x (the slabs' pads) stay zero in q up to rounding."""
    p = x.shape[0]
    ql, rl = tsqr(x.T)
    q2, r = torch.linalg.qr(mesh.all_gather(rl).reshape(mesh.size * p, p),
                            mode="reduced")
    q = ql @ q2.reshape(mesh.size, p, p)[mesh.rank]
    q, r = _fix_signs(q, r)
    return q.T, r
