"""Forward-Euler FDTD ground-truth integrators (port of
`lanczos_tpu/methods/fdtd.py`, reference `methods/fdtd.hpp`).

u(T_end) integrated as u += dt * A u for nsteps: the physics oracle the
reference validates Lanczos-expm against (test_lanczos.cu:118-123,
:294-301).  The operator folds dt into its weights (`scaled`; the port's
one operator, the Maxwell stencil, has it), so a step is one operator pass
plus one in-place add, `u.add_(a.mm(u))`.  The one-pass in-place step kernel (K5,
`fdtd_step_inplace`) is not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch


def _stepper(a, u0: torch.Tensor, nsteps: int, t_end: float, apply):
    a_dt = a.scaled(torch.tensor(t_end / nsteps, dtype=u0.dtype))
    u = u0.clone()
    for _ in range(nsteps):
        u.add_(apply(a_dt, u))
    return u


def fdtd_vector(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Returns u(T_end) (full state; index with lc at the call site)."""
    return _stepper(a, u0, nsteps, t_end, lambda op, u: op.mv(u))


def fdtd_block(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Block version (reference `ftdt_block`, fdtd.hpp:34): U += dt * A U.
    U is BLOCK-MAJOR (p, *state)."""
    return _stepper(a, u0, nsteps, t_end, lambda op, u: op.mm(u))
