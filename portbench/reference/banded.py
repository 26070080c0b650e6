"""The synthetic banded SPD matrix in plain PyTorch, as its diagonals
(the DIA form: no index arrays), applied to block-major states (p, n).
Imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.reference.arith import Arith


class Banded:
    def __init__(self, upper: dict, diag: torch.Tensor, ar: Arith):
        self.ar = ar
        self.n = diag.numel()
        self.diag = ar.r(diag.to(ar.dtype))
        self.upper = {o: ar.r(u.to(ar.dtype)) for o, u in upper.items()}

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        xr = self.ar.r(x.to(self.ar.dtype))
        y = self.diag * xr
        for o, u in self.upper.items():
            y[:, :-o] += u * xr[:, o:]
            y[:, o:] += u * xr[:, :-o]
        return y
