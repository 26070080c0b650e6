"""Each count of `counts/` against a hand count at a small size."""

from __future__ import annotations

from portbench.counts import eigsh, expm, fdtd
from portbench.inputs import maxwell_unknowns, nnz_banded


def test_maxwell_unknowns_by_hand():
    # N = 2: E components 2*2*3 = 12 each, H components 2*3*3 = 18 each
    assert maxwell_unknowns(2) == 3 * 12 + 3 * 18


def test_expm_count_by_hand():
    cfg = {"n_grid": 2, "dtype": "float32"}
    n = 90
    got = expm.request(cfg, {"p": 3, "m": 4})
    # start: read B, write Q_0; 4 iterations of read Q_j, Q_{j-1}, write W
    assert got["bytes"] == (2 + 4 * 3) * n * 3 * 4
    # 4 products of 7 an unknown and column, 2 + 5 * 4 Grams/mixes of 2 p^2
    assert got["flops"] == 4 * 7 * n * 3 + 22 * 2 * 9 * n
    assert expm.request(dict(cfg, dtype="float64"), {"p": 3, "m": 4})["bytes"] == 2 * got["bytes"]


def test_fdtd_count_by_hand():
    got = fdtd.request({"n_grid": 2, "dtype": "float32", "fdtd_steps": 5}, {"p": 2})
    assert got == {"bytes": 5 * 2 * 90 * 2 * 4, "flops": 5 * 8 * 90 * 2}


def test_banded_nnz_by_hand():
    cfg = {"offsets": [1, 3, 20]}
    # n = 10: the diagonal, 2 * 9 and 2 * 7; offset 20 does not fit
    assert nnz_banded(cfg, 10) == 10 + 18 + 14


def test_eigsh_count_by_hand():
    cfg = {"rows": 10, "offsets": [1, 3], "dtype": "float32"}
    n, p, m, k = 10, 2, 2, 1
    S, V = n * p * 4, (10 + 18 + 14) * 4
    want = 3 * S                                      # QR of the start block
    want += V + S + S + 2 * (2 * 1 + 3) * S + 3 * S   # j=0: A Q_0, W, CGS2 vs 1, QR
    want += 2 * (2 * 1 + 3) * S + 3 * S               # j=1: q-side CGS2 vs 1, re-QR
    want += V + S + S + S + 2 * (2 * 2 + 3) * S + S   # A Q_1, Q_0, W, CGS2 vs 2, last R
    want += m * S + n * k * 4                          # Ritz vectors
    want += V + n * k * 4                              # residuals
    got = eigsh.request(cfg, {"p": p, "m": m, "k": k})
    assert got["bytes"] == want
    g = 2 * p * p * n
    nnz = 42
    flops = g                                          # start QR
    flops += 2 * nnz * p + 2 * g + 4 * 1 * g + g       # j=0
    flops += 4 * 1 * g + g                             # j=1 q-side
    flops += 2 * nnz * p + 3 * g + 4 * 2 * g + g       # j=1
    flops += 2 * m * p * k * n + 2 * nnz * k
    assert got["flops"] == flops
