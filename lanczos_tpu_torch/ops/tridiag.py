"""(Block-)tridiagonal T assembly from Lanczos alpha/beta coefficients.

Port of `lanczos_tpu/ops/tridiag.py` (the reference's `Assemble_T`,
`source/objects/tridiagonal_matrix.hpp:91-205`, without its two copy-paste
bugs, SURVEY.md §7).
"""

from __future__ import annotations

import torch


def assemble_tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Dense symmetric tridiagonal T (m x m).

    alphas: (m,) diagonal; betas: (m-1,) off-diagonal (beta_1..beta_{m-1}
    in the recurrence's numbering — the subdiagonal norms).
    """
    t = torch.diag(alphas)
    if alphas.shape[0] > 1:
        t = t + torch.diag(betas, -1) + torch.diag(betas, 1)
    return t


def assemble_block_tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Dense symmetric block-tridiagonal T (m*p x m*p).

    alphas: (m, p, p) diagonal blocks (each symmetric); betas: (m-1, p, p)
    subdiagonal blocks, placed below the diagonal with their transposes
    above it (exact for non-symmetric blocks too).
    """
    m, p, _ = alphas.shape
    t = alphas.new_zeros((m * p, m * p))
    for j in range(m):
        t[j * p : (j + 1) * p, j * p : (j + 1) * p] = alphas[j]
    for j in range(m - 1):
        t[(j + 1) * p : (j + 2) * p, j * p : (j + 1) * p] = betas[j]
        t[j * p : (j + 1) * p, (j + 1) * p : (j + 2) * p] = betas[j].T
    return t
