"""The 3-D Maxwell curl operator in plain PyTorch, built from its
definition: the reference's ``A = D diag(w)`` (`build_A_ell.hpp:10`) on
the flat state u = [E1, E2, E3, H1, H2, H3], each component a (z, y, x)
grid of the staggered (Yee) lattice on the unit cube.

Every grid spacing of the reference's lattice is h = 1/(N+1), so the
energy weights are +h^3 on E and -h^3 on H and each curl entry is +-1/h:
every block of A is sign * h^2 times a first difference along one axis,
"fwd" (v[k+1] - v[k], N+1 points in, N out) or "bwd" (v[k] - v[k-1]
with zero ends, N in, N+1 out).  The sign folds the H weights' -1.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.arith import Arith

E1, E2, E3, H1, H2, H3 = range(6)

# (out, in, sign, axis (0 z, 1 y, 2 x), kind): E rows read the curl of H,
# H rows the curl of E
BLOCKS = (
    (E1, H2, -1.0, 0, "fwd"), (E1, H3, +1.0, 1, "fwd"),
    (E2, H1, +1.0, 0, "fwd"), (E2, H3, -1.0, 2, "fwd"),
    (E3, H1, -1.0, 1, "fwd"), (E3, H2, +1.0, 2, "fwd"),
    (H1, E2, -1.0, 0, "bwd"), (H1, E3, +1.0, 1, "bwd"),
    (H2, E1, +1.0, 0, "bwd"), (H2, E3, -1.0, 2, "bwd"),
    (H3, E1, -1.0, 1, "bwd"), (H3, E2, +1.0, 2, "bwd"),
)


def shapes(n: int):
    """(z, y, x) shape of each component at grid N."""
    return ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n),
            (n + 1, n + 1, n), (n + 1, n, n + 1), (n, n + 1, n + 1))


def _diff(v: torch.Tensor, axis: int, kind: str) -> torch.Tensor:
    dim = v.ndim - 3 + axis
    if kind == "fwd":
        return torch.diff(v, dim=dim)
    pad = list(v.shape)
    pad[dim] = 1
    zero = v.new_zeros(pad)
    return torch.diff(v, dim=dim, prepend=zero, append=zero)


class Maxwell:
    """A (scaled by `scale`, e.g. an Euler step's dt) on block-major flat
    states (p, n) in the arithmetic `ar`."""

    def __init__(self, n_grid: int, ar: Arith, scale: float = 1.0):
        self.n_grid = n_grid
        self.ar = ar
        self.shapes = shapes(n_grid)
        self.sizes = [s[0] * s[1] * s[2] for s in self.shapes]
        self.n = sum(self.sizes)
        self.coef = scale / float(n_grid + 1) ** 2

    def components(self, x: torch.Tensor):
        out, o = [], 0
        for s, sz in zip(self.shapes, self.sizes):
            out.append(x[:, o:o + sz].reshape((x.shape[0],) + s))
            o += sz
        return out

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """(p, n) -> A x in the arithmetic's type.  Each product is
        coefficient times state, so under TF32 the state is rounded before
        the difference, as a TF32 product of A with x would round it."""
        ar = self.ar
        xs = [ar.r(c.to(ar.dtype)) for c in self.components(x)]
        coef = ar.r(torch.tensor(self.coef, dtype=ar.dtype, device=x.device))
        y = torch.empty((x.shape[0], self.n), dtype=ar.dtype, device=x.device)
        ys = self.components(y)
        for c in range(6):
            (s0, d0), (s1, d1) = [
                (sign, _diff(xs[in_c], axis, kind))
                for out_c, in_c, sign, axis, kind in BLOCKS if out_c == c]
            ys[c].copy_((s0 * d0 + s1 * d1) * coef)
        return y
