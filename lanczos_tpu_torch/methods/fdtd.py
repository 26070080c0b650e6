"""Forward-Euler FDTD ground-truth integrators (port of
`lanczos_tpu/methods/fdtd.py`, reference `methods/fdtd.hpp`).

u(T_end) integrated as u += dt * A u for nsteps: the physics oracle the
reference validates Lanczos-expm against (test_lanczos.cu:118-123,
:294-301).  As in the JAX package, an operator with `scaled` gets dt folded
into its weights; the folded-plane operator, the one with `scaled`, also
has `fdtd_step`, the one-pass step u + (dt A) u (K5) at every block width.
That step writes into a second buffer: the loop swaps two buffers of its
own and never writes u0.  Other operators step u + dt * (A u).
"""

from __future__ import annotations

import torch


def _integrate(a, u0: torch.Tensor, nsteps: int, t_end: float, block: bool):
    dt = torch.tensor(t_end / nsteps, dtype=u0.dtype, device=u0.device)
    if hasattr(a, "scaled"):
        # dt folded into the weights (JAX `_maybe_fold_dt`), one pass a step
        step = a.scaled(dt).fdtd_step
        bufs = (torch.empty_like(u0), torch.empty_like(u0))
        u = u0
        for i in range(nsteps):
            u = step(u, bufs[i % 2])
        return u
    apply = a.mm if block else a.mv
    u = u0
    for _ in range(nsteps):
        u = u + dt * apply(u)
    return u


def fdtd_vector(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Returns u(T_end) (full state; index with lc at the call site)."""
    return _integrate(a, u0, nsteps, t_end, block=False)


def fdtd_block(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Block version (reference `ftdt_block`, fdtd.hpp:34): U += dt * A U.
    U is BLOCK-MAJOR (p, *state)."""
    return _integrate(a, u0, nsteps, t_end, block=True)
