"""Right-hand-side builders (reference `matrix_a/build_ell_utils.hpp:228-280`).

Same math, NumPy-vectorized: a 3-D Gaussian bump evaluated over the first
N*N*(N+1) entries of the state vector (the reference fills only the leading
`X.size()` entries of b and leaves the rest zero), or uniform random in
[1, 2) (the reference's `rand()/RAND_MAX + 1`).
"""

from __future__ import annotations

import numpy as np


def _gaussian_grid(n: int, shift: float, n_rows: int, dtype=np.float64):
    h = 1.0 / (n + 1)
    x = np.linspace(h, 1.0 - h, n, dtype=dtype)
    y = np.linspace(h, 1.0 - h, n, dtype=dtype)
    z = np.linspace(h / 2, 1.0 - h / 2, n + 1, dtype=dtype)
    size = x.size * y.size * z.size
    i = np.arange(size)
    X = x[i % n]
    Y = y[(i // n) % n]
    Z = z[(i // (n * n)) % (n + 1)]
    b = np.zeros(n_rows, dtype=dtype)
    b[:size] = np.exp(-((X - shift) ** 2) - (Y - shift) ** 2 - (Z - shift) ** 2)
    return b


def gaussian_vector_b(n: int, n_rows: int, dtype=np.float64) -> np.ndarray:
    """Single Gaussian bump at 0.5 (build_ell_utils.hpp:228)."""
    return _gaussian_grid(n, 0.5, n_rows, dtype)


def random_vector_b(n_rows: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(n_rows) + 1.0).astype(dtype)


def gaussian_matrix_B(n: int, n_rows: int, n_col: int, dtype=np.float64) -> np.ndarray:
    """n_col shifted Gaussians (shift = 0.1*(i+1)), build_ell_utils.hpp:252.

    Block-major (n_col, n_rows): the TPU-native block convention puts the
    block axis first (leading batch dim), unlike the reference's
    column-major tall matrices.
    """
    return np.stack(
        [_gaussian_grid(n, 0.1 * (i + 1), n_rows, dtype) for i in range(n_col)],
        axis=0,
    )


def random_matrix_B(n_rows: int, n_col: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Block-major (n_col, n_rows); values in [1, 2)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n_col, n_rows)) + 1.0).astype(dtype)
