"""The arithmetic the reference runs in: its judge in float64, its
control in TF32 (float32 storage and sums, every product's operands
rounded to TF32's 10 explicit mantissa bits, as a TF32 tensor-core
product rounds them).  The configurations state float32 with TF32 off
(the port's `ops/precision.py`), so TF32 is the nearest precision below
it, the step that would tempt a later change.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to nearest-even with 10 explicit mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -8192
    return i.view(torch.float32)


class Arith:
    """mode "f64": the judge, every value float64.  mode "tf32": the
    control, float32 values, product operands rounded to TF32."""

    def __init__(self, mode: str):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand as this arithmetic takes it."""
        return x if self.mode == "f64" else round_tf32(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) * self.r(b)

    def norm(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        xr = self.r(x)
        return torch.sqrt(torch.sum(xr * xr, dim=dim))

    def sqrtm_invsqrtm(self, g: torch.Tensor):
        """(sqrtm(g), its inverse) of a symmetric p x p Gram through its
        eigendecomposition, with |w| against rounding's negative
        eigenvalues (the reference's `my_sqrtm_cusolver.hpp`)."""
        w, v = torch.linalg.eigh(0.5 * (g + g.T))
        s = torch.sqrt(w.abs())
        return self.mm(v * s, v.T), self.mm(v / s, v.T)

    def expm_sym(self, t: torch.Tensor) -> torch.Tensor:
        w, v = torch.linalg.eigh(0.5 * (t + t.T))
        return self.mm(v * torch.exp(w), v.T)
