"""Plain reference of the `fdtd` driver: `fdtd_steps` forward-Euler steps
u <- u + dt A u, dt = t_end / fdtd_steps (the reference's `methods/fdtd.hpp`),
on the reference's own operator from the same start blocks the program
was given.  Each request's answer is the final state at its receiver lc;
the driver keeps the whole final state of the first request of each
start block, judged entry by entry.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference.arith import Arith
from portbench.reference.maxwell import Maxwell


def euler(op, u0: torch.Tensor, steps: int) -> torch.Tensor:
    """`steps` steps u + (dt A) u; op carries dt in its scale."""
    u = u0.to(op.ar.dtype)
    for _ in range(steps):
        u = u + op.mm(u)
    return u


def _final_states(cfg, tr, seed, device, blks, mode):
    ar = Arith(mode)
    steps = int(cfg["fdtd_steps"])
    op = Maxwell(int(cfg["n_grid"]), ar, scale=float(cfg["t_end"]) / steps)
    for blk in sorted(blks):
        u0 = inputs.maxwell_block(cfg, tr["p"], seed, blk, device)
        yield blk, euler(op, u0, steps)
        del u0


def judge(cfg, tr, seed, device, records, kept) -> dict:
    """answer_rel_err: the largest relative error of a request's receiver
    values; state_rel_err: the largest ||u - u_ref|| / ||u_ref|| of a
    kept final state (kept: {blk: (p, n) flat state})."""
    worst_answer, worst_state = 0.0, 0.0
    blks = {r["blk"] for r in records} | set(kept)
    for blk, u in _final_states(cfg, tr, seed, device, blks, "f64"):
        for r in records:
            if r["blk"] != blk:
                continue
            want = u[:, r["lc"]].cpu().numpy()
            got = np.asarray(r["answer"], dtype=np.float64)
            err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            worst_answer = max(worst_answer, err) if np.isfinite(err) else float("inf")
        if blk in kept:
            got = kept[blk].to(u.device, torch.float64)
            err = float(torch.linalg.norm(got - u) / torch.linalg.norm(u))
            worst_state = max(worst_state, err) if np.isfinite(err) else float("inf")
            del got
        del u
    return {"answer_rel_err": worst_answer, "state_rel_err": worst_state}


def control(cfg, tr, seed, device, plan_records):
    """The reference in TF32 in the program's place, for the same
    requests: (records, kept) as the driver makes them."""
    records = [dict(r) for r in plan_records]
    kept = {}
    blks = {r["blk"] for r in records}
    for blk, u in _final_states(cfg, tr, seed, device, blks, "tf32"):
        for r in records:
            if r["blk"] == blk:
                r["answer"] = u[:, r["lc"]].double().cpu().numpy()
        kept[blk] = u
    return records, kept
