"""Least traffic of one `fdtd` request: `steps` forward-Euler steps
u <- u + dt A u on p columns of n logical unknowns.  Each step depends on
the whole previous state, so each reads the state once and writes it once;
A is a stencil of constant coefficients.  Operations: the product's 7 an
unknown (4 taps) plus the add, per column and step."""

from __future__ import annotations

from portbench.counts.expm import ITEMSIZE, STENCIL_FLOPS
from portbench.inputs import maxwell_unknowns


def request(cfg: dict, tr: dict) -> dict:
    n, p, steps = maxwell_unknowns(int(cfg["n_grid"])), int(tr["p"]), int(cfg["fdtd_steps"])
    block = n * p * ITEMSIZE[cfg["dtype"]]
    return {"bytes": steps * 2 * block,
            "flops": steps * (STENCIL_FLOPS + 1) * n * p}
