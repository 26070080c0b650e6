"""The synthetic SuiteSparse-style banded SPD matrix of the assembled slice.

NumPy/scipy copy of `synth_suitesparse_banded` in
`benchmarks/suitesparse_scale.py` (BASELINE.json config 4: an assembled
>= 10M-row, >= 100M-nnz matrix through the windowed-ELL SpMM and block
Lanczos eigsh on one chip).  The same seed gives the same CSR arrays.
"""

from __future__ import annotations

import numpy as np


def synth_suitesparse_banded(n: int, seed: int = 0):
    """Synthetic SuiteSparse-style SPD matrix: 11 scattered diagonals
    (near + mid + far bands, like a high-order FD/FE discretization),
    random entries, diagonally dominant, plus five separated spikes on the
    diagonal so that the top of the spectrum converges.  nnz ~ 11n.
    Returns scipy CSR in float32."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    offsets = [0, 1, -1, 7, -7, 64, -64, 513, -513, 4999, -4999]
    offsets = [o for o in offsets if abs(o) < n]
    diags = []
    for o in offsets:
        ln = n - abs(o)
        if o == 0:
            diags.append(np.zeros(ln))  # filled below for dominance
        else:
            diags.append(rng.standard_normal(ln) * 0.5)
    a = sp.diags(diags, offsets, format="csr")
    a = 0.5 * (a + a.T)
    rowsum = np.asarray(np.abs(a).sum(axis=1)).ravel()
    # separated dominant modes: they clear the band continuum's edge (~2x
    # the largest row sum) by a real gap
    spikes = np.zeros(n)
    spikes[rng.choice(n, size=5, replace=False)] = [500, 450, 400, 350, 300]
    a = a + sp.diags(rowsum + 1.0 + spikes)
    return a.tocsr().astype(np.float32)
