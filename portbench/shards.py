"""A rank's share of the banded matrix of a cell on several cards, made
from the seed as `inputs.banded_diagonals` makes the whole: the rows a
rank holds, their diagonals and their CSR, and the rows whose products
the judge checks.  Shared by the driver and the
plain reference; imports nothing of the port.

The ranks split the rows as the port's row-sharded operators do: rank r
holds rows [r rows_loc, (r + 1) rows_loc), rows_loc = ceil(n / size)
rounded up to 128 rows, the last rank's rows past n absent.
"""

from __future__ import annotations

import torch

LANES = 128
PROBE_STRIDE = 1024


def bounds(n: int, size: int, rank: int) -> tuple[int, int, int]:
    """(lo, hi, rows_loc): rank `rank`'s rows [lo, hi) of n over `size`
    ranks, hi - lo <= rows_loc."""
    rows_loc = -(-(-(-n // size)) // LANES) * LANES
    lo = min(rank * rows_loc, n)
    return lo, min(lo + rows_loc, n), rows_loc


def probe_rows(lo: int, hi: int, halo: int) -> torch.Tensor:
    """The rows of [lo, hi) whose products the judge checks: the 2 halo
    rows at each edge of the shard, which read the rows a halo exchange
    brings, and every PROBE_STRIDE-th row between them; sorted (int64)."""
    edge = torch.arange(lo, min(hi, lo + 2 * halo), dtype=torch.int64)
    inner = torch.arange(lo, hi, PROBE_STRIDE, dtype=torch.int64)
    tail = torch.arange(max(lo, hi - 2 * halo), hi, dtype=torch.int64)
    return torch.unique(torch.cat([edge, inner, tail]))


def rank_diagonals(upper: dict, diag: torch.Tensor, lo: int, hi: int) -> dict:
    """{signed offset o: (hi - lo,)}: A[i, i + o] for the rows i in
    [lo, hi), zero where i + o falls outside the matrix; copies, so the
    whole diagonals can be freed."""
    n = diag.numel()
    coef = {0: diag[lo:hi].clone()}
    for o, u in upper.items():
        right = torch.zeros(hi - lo, dtype=u.dtype, device=u.device)
        top = min(hi, n - o)
        if top > lo:
            right[: top - lo] = u[lo:top]  # A[i, i + o] = u[i], i < n - o
        left = torch.zeros_like(right)
        start = max(lo, o)
        if hi > start:
            left[start - lo :] = u[start - o : hi - o]  # A[i, i - o] = u[i - o], i >= o
        coef[o], coef[-o] = right, left
    return coef


def rows_csr(coef: dict, lo: int, hi: int, n: int):
    """Rows [lo, hi) of the n x n matrix as a scipy CSR in float32 with
    global columns, sorted, every entry of the band inside the matrix
    stored (the whole matrix's `inputs.banded_csr` rows), built on the
    diagonals' device and copied to the host once."""
    import scipy.sparse as sp

    offs = sorted(coef)
    dev = coef[0].device
    i = torch.arange(lo, hi, device=dev, dtype=torch.int64)
    vals = torch.stack([coef[o] for o in offs], dim=1)
    cols = torch.stack([i + o for o in offs], dim=1)
    del i
    keep = (cols >= 0) & (cols < n)
    counts = torch.cumsum(keep.sum(dim=1), 0)
    nnz = int(counts[-1]) if hi > lo else 0
    # scipy keeps one index type for indptr and indices
    index = torch.int32 if max(nnz, n) < 2**31 else torch.int64
    indptr = torch.zeros(hi - lo + 1, dtype=index, device=dev)
    indptr[1:] = counts
    data = vals[keep].cpu().numpy()
    del vals
    indices = cols[keep].to(index).cpu().numpy()
    del cols, keep
    a = sp.csr_matrix((data, indices, indptr.cpu().numpy()), shape=(hi - lo, n))
    a.has_sorted_indices = True
    a.has_canonical_format = True
    return a
