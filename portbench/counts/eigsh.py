"""Least traffic of one `eigsh` request: m-step block Lanczos with QR
normalization and full re-orthogonalization (the residual against the
whole basis every step and, since breakdown_eps > 0, the new block
against the basis before it too), the Ritz vectors, then one product for
the measured residuals.

With S the bytes of one block (n rows, p columns) and V the matrix's
values (nnz * itemsize; no index bytes, as a DIA form of a banded matrix
needs none), what the data dependencies force:
- a QR of a block (its R before its Q): read it twice, write it: 3S;
- a CGS pass against b blocks (all coefficients before any update): read
  the basis twice and the block twice, write the block: (2b + 3)S; CGS2 is
  two passes;
- step j (0..m-1), basis of j + 1 blocks after it: the product A Q_j
  (V + S), read Q_{j-1} (j >= 1) and write the residual (S), its CGS2
  against j + 1 blocks; for j >= 1 first the new block's CGS2 against
  the j blocks before it and its re-QR; the QR that makes Q_{j+1}
  (j < m-1) or reads the last residual for its R (j = m-1: S);
- start: the QR of the start block;
- Ritz vectors: read the basis (mS), write k vectors;
- residuals: V and the k vectors read once (the product, the subtraction
  and the norms fuse).
Operations: 2 a stored value and column for each product, 2 p^2 an
unknown for each Gram, mix, CGS coefficient and update, 2 p^2 an unknown
for a QR, 2 m p k an unknown for the Ritz vectors.
"""

from __future__ import annotations

from portbench.counts.expm import ITEMSIZE
from portbench.inputs import nnz_banded


def request(cfg: dict, tr: dict) -> dict:
    n, p, m, k = int(cfg["rows"]), int(tr["p"]), int(tr["m"]), int(tr["k"])
    item = ITEMSIZE[cfg["dtype"]]
    nnz = nnz_banded(cfg, n)
    S, V = n * p * item, nnz * item
    gram = 2 * p * p * n  # the operations of one Gram, mix or QR of a block

    def cgs2(b):
        return 2 * (2 * b + 3) * S, 4 * b * gram

    nbytes, flops = 3 * S, gram  # the QR of the start block
    for j in range(m):
        if j >= 1:  # the new block against the j before it, then its re-QR
            cb, cf = cgs2(j)
            nbytes += cb + 3 * S
            flops += cf + gram
        cb, cf = cgs2(j + 1)
        nbytes += V + S + (S if j else 0) + S + cb + (3 * S if j < m - 1 else S)
        flops += 2 * nnz * p + (3 if j else 2) * gram + cf + gram
    nbytes += m * S + n * k * item + V + n * k * item
    flops += 2 * m * p * k * n + 2 * nnz * k
    return {"bytes": nbytes, "flops": flops}
