"""Tall-skinny QR (TSQR), port of `lanczos_tpu/ops/tsqr.py`.

The block-Lanczos variant of BASELINE.json config 3 normalizes each Krylov
block by QR instead of the reference's sqrtm(W^T W)
(`block_lanczos.hpp:28-34`): it never squares the condition number.

Two-level tree: split the n rows into c chunks, QR each chunk (one batched
`torch.linalg.qr`), QR the stacked (c*p, p) R factors, and recombine.
Signs are normalized (diag(R) >= 0), so the factorization is unique and
does not depend on the chunking.  The sharded variant (`tsqr_sharded`)
waits for the multi-device operators (ROADMAP Queue 1 item 12).
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
