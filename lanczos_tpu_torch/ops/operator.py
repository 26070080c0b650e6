"""Linear-operator protocol for the Lanczos methods.

Every Lanczos/FDTD method takes any object implementing this protocol.
Operators are `torch.nn.Module`s whose weights are registered buffers, so
`.to(device)` moves them as a whole; nothing here has a backward.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)


class LinearOperator(torch.nn.Module, abc.ABC):
    """A symmetric linear operator y = A @ x."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, int]:
        ...

    @property
    @abc.abstractmethod
    def dtype(self) -> torch.dtype:
        ...

    @abc.abstractmethod
    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """Matrix-vector product on a state (an (n,) vector for matrix
        formats; operators may use richer state shapes, e.g. the Maxwell
        stencil's stacked field layout)."""

    @abc.abstractmethod
    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """Block product, BLOCK-MAJOR: X: (p, *state_shape) -> same."""


class MatrixOperator(LinearOperator):
    """Dense-matrix operator (tests and small oracles); the matrix is a
    registered buffer."""

    def __init__(self, a: torch.Tensor):
        super().__init__()
        self.register_buffer("a", torch.as_tensor(a))

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    def mv(self, x):
        return self.a @ x

    def mm(self, X):
        # X block-major (p, n): (A X^T)^T = X A^T
        return X @ self.a.T


def state_trace(q: torch.Tensor, lc: int, block: bool) -> torch.Tensor:
    """Receiver extraction q[..., lc] without flattening the state: lc is
    unravelled into the native state shape, so one element per block
    column is read.  block=True treats axis 0 as the block axis.  Returns
    a copy, so later in-place updates of q leave it alone."""
    state_shape = tuple(q.shape[1:] if block else q.shape)
    idx = tuple(int(i) for i in np.unravel_index(int(lc), state_shape))
    if block:
        return q[(slice(None),) + idx].clone()
    return q[idx].clone()
