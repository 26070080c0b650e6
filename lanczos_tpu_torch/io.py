"""Matrix IO: load external sparse matrices into the port (port of
`lanczos_tpu/io.py`).

Matrix Market (`.mtx`, `.mtx.gz`, the SuiteSparse interchange format) and
scipy `.npz` files, built into any of the containers of `ops/formats.py`
or the windowed-ELL operator of `ops/window_ell.py`, on `device` (default
"cuda").  The row-sharded multi-device operators are not ported (ROADMAP
Queue 1 item 12): a `mesh` argument raises.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def load_sparse(path: str):
    """Load a sparse matrix from .mtx/.mtx.gz (Matrix Market) or .npz
    (scipy.sparse.save_npz).  Returns scipy CSR."""
    import scipy.sparse as sp

    low = path.lower()
    if low.endswith(".npz"):
        return sp.load_npz(path).tocsr()
    if low.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread

        a = mmread(path)
        # 'array'-format files come back as a dense ndarray
        return sp.csr_matrix(a) if not sp.issparse(a) else a.tocsr()
    raise ValueError(f"unknown sparse matrix format: {path}")


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "row-sharded operators (mesh=...) are not ported to "
            "lanczos_tpu_torch yet (ROADMAP Queue 1 item 12)"
        )


def operator_from_file(
    path: str,
    *,
    format: str = "ell",
    dtype=None,
    mesh=None,
    reorder: str = "auto",
    device="cuda",
):
    """Build a ready-to-use operator from a matrix file.

    format: "ell" | "csr" | "coo" | "bsr" | "dia" (the containers of
    `ops/formats.py`) | "windowed" (the windowed-ELL SpMM, K8) | "auto"
    (see `auto_operator`).  dtype defaults to float32."""
    from lanczos_tpu_torch.ops import formats as F

    _no_mesh(mesh)
    dtype = torch.float32 if dtype is None else dtype
    a = load_sparse(path)
    if format == "auto":
        return auto_operator(a, dtype=dtype, reorder=reorder, device=device)
    if format == "windowed":
        from lanczos_tpu_torch.ops.window_ell import windowed_from_scipy

        return windowed_from_scipy(a, dtype=dtype, reorder=reorder,
                                   device=device)
    builders = {
        "ell": F.ell_from_scipy,
        "csr": F.csr_from_scipy,
        "coo": F.coo_from_scipy,
        "bsr": F.bsr_from_scipy,
        "dia": F.dia_from_scipy,
    }
    if format not in builders:
        raise ValueError(f"unknown format {format!r}")
    return builders[format](a, dtype=dtype, device=device)


def auto_operator(a, *, dtype=None, mesh=None, reorder: str = "auto",
                  max_diags: int = 32, device="cuda"):
    """Operator selection for an assembled scipy matrix, in the JAX
    package's order: DIA when the nonzeros lie on <= max_diags distinct
    diagonals (square matrices), else the windowed-ELL operator, else
    gathered ELL, with a warning naming the fallback."""
    import scipy.sparse as sp

    from lanczos_tpu_torch.ops import formats as F
    from lanczos_tpu_torch.ops.window_ell import PlanError, windowed_from_scipy

    _no_mesh(mesh)
    dtype = torch.float32 if dtype is None else dtype
    a = a.tocsr() if sp.issparse(a) else sp.csr_matrix(np.asarray(a))
    coo = a.tocoo()
    ndiag = (len(np.unique(coo.col.astype(np.int64) - coo.row))
             if coo.nnz else 1)
    if a.shape[0] == a.shape[1] and ndiag <= max_diags:
        return F.dia_from_scipy(a, dtype=dtype, device=device)
    try:
        return windowed_from_scipy(a, dtype=dtype, reorder=reorder,
                                   device=device)
    except PlanError as e:
        warnings.warn(
            f"auto_operator: the windowed-ELL plan failed ({e}); falling "
            "back to gathered ELL (EllMatrix)", stacklevel=2,
        )
        return F.ell_from_scipy(a, dtype=dtype, device=device)
