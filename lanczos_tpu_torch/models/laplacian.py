"""Laplacian test matrices (BASELINE.json config 1: 10k x 10k 2-D Laplacian).

NumPy/scipy copy of `lanczos_tpu/models/laplacian.py`."""

from __future__ import annotations

import numpy as np


def laplacian_1d_scipy(n: int):
    import scipy.sparse as sp

    return sp.diags(
        [np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
        [-1, 0, 1],
        format="csr",
    )


def laplacian_2d_scipy(nx: int, ny: int | None = None):
    """Standard 5-point 2-D Laplacian, (nx*ny) x (nx*ny), SPD."""
    import scipy.sparse as sp

    ny = nx if ny is None else ny
    lx = laplacian_1d_scipy(nx)
    ly = laplacian_1d_scipy(ny)
    return (
        sp.kron(sp.identity(ny), lx) + sp.kron(ly, sp.identity(nx))
    ).tocsr()


def laplacian_3d_scipy(nx: int, ny: int | None = None, nz: int | None = None):
    import scipy.sparse as sp

    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    lx = laplacian_1d_scipy(nx)
    ly = laplacian_1d_scipy(ny)
    lz = laplacian_1d_scipy(nz)
    ix, iy, iz = (sp.identity(k) for k in (nx, ny, nz))
    return (
        sp.kron(iz, sp.kron(iy, lx))
        + sp.kron(iz, sp.kron(ly, ix))
        + sp.kron(lz, sp.kron(iy, ix))
    ).tocsr()
