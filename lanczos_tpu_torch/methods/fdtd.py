"""Forward-Euler FDTD ground-truth integrators (port of
`lanczos_tpu/methods/fdtd.py`, reference `methods/fdtd.hpp`).

u(T_end) integrated as u += dt * A u for nsteps: the physics oracle the
reference validates Lanczos-expm against (test_lanczos.cu:118-123,
:294-301).  As in the JAX package, an operator with `scaled` gets dt folded
into its weights.  The folded-plane operator also has `fdtd_step`, the
one-pass step u + (dt A) u (K5) at every block width, which writes into a
second buffer: the loop swaps two buffers of its own and never writes u0.
As JAX's `_inplace_step`, the loop takes it only where the operator's
`supports_fdtd_inplace(p)` holds: on a bf16 state it does not, and each
step is K1 then a bf16 add (dt made in the state's dtype, so rounded to
bf16 before it is folded into the f32 weights, as JAX does).
The distributed operator has `scaled` and no `fdtd_step` (JAX's branch):
it steps u + (dt A) u as K1 plus an add, since K5's identity term on its
halo-filled work copy would copy the halo planes into the state's pads.
Other operators step u + dt * (A u).
`euler_steps` is the loop itself, from any start state for any number of
steps; `methods/checkpoint.py` runs it chunk by chunk.
"""

from __future__ import annotations

import torch


def euler_steps(a, u: torch.Tensor, nsteps: int, dt: torch.Tensor, *,
                block: bool, bufs=None) -> torch.Tensor:
    """nsteps forward-Euler steps u <- u + dt A u from u, which it never
    writes.  An operator with `scaled` takes dt into its weights and, where
    its `supports_fdtd_inplace` takes u's width and dtype, steps
    through its one-pass `fdtd_step`, each step into whichever of the two
    buffers `bufs` (made here when None) does not hold the current state:
    the result is then one of them, and a later call with the same bufs
    continues from it.  An operator with `scaled` and no such step steps
    u + (dt A) u, and other operators u + dt * (A u), into new tensors.
    Returns u itself when nsteps is 0."""
    p = u.shape[0] if block else 1
    if hasattr(a, "fdtd_step") and a.supports_fdtd_inplace(p, u.dtype):
        # dt folded into the weights (JAX `_maybe_fold_dt`), one pass a step
        step = a.scaled(dt).fdtd_step
        if bufs is None:
            bufs = (torch.empty_like(u), torch.empty_like(u))
        for _ in range(nsteps):
            out = bufs[1] if u.data_ptr() == bufs[0].data_ptr() else bufs[0]
            u = step(u, out)
        return u
    if hasattr(a, "scaled"):
        a_dt = a.scaled(dt)
        apply = a_dt.mm if block else a_dt.mv
        for _ in range(nsteps):
            u = u + apply(u)
        return u
    apply = a.mm if block else a.mv
    for _ in range(nsteps):
        u = u + dt * apply(u)
    return u


def _integrate(a, u0: torch.Tensor, nsteps: int, t_end: float, block: bool):
    dt = torch.tensor(t_end / nsteps, dtype=u0.dtype, device=u0.device)
    return euler_steps(a, u0, nsteps, dt, block=block)


def fdtd_vector(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Returns u(T_end) (full state; index with lc at the call site)."""
    return _integrate(a, u0, nsteps, t_end, block=False)


def fdtd_block(a, u0: torch.Tensor, nsteps: int, t_end: float) -> torch.Tensor:
    """Block version (reference `ftdt_block`, fdtd.hpp:34): U += dt * A U.
    U is BLOCK-MAJOR (p, *state)."""
    return _integrate(a, u0, nsteps, t_end, block=True)
