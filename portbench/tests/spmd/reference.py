"""Plain reference of the test-only `spmd` driver: the same products in
float64 from the same inputs, each rank's halo taken by an all-gather of
every rank's edge rows (plain `torch.distributed`, nothing of the port),
then every answer's edge rows and each whole answer kept against it.  The
reading is the worst rank's."""

from __future__ import annotations

import torch
import torch.distributed as dist

from portbench.tests.spmd import inputs as spmd_inputs


def window(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """`x`, this rank's block, with `halo` rows of each neighbour's on
    either side (zeros past the ends), by an all-gather of every rank's
    edge rows."""
    rank, size, h = group.rank, group.size, halo
    edges = torch.cat([x[:, :h], x[:, -h:]], dim=1).contiguous()
    parts = [torch.empty_like(edges) for _ in range(size)]
    dist.all_gather(parts, edges, group=group.process_group)
    zeros = torch.zeros_like(edges[:, :h])
    left = parts[rank - 1][:, h:] if rank > 0 else zeros
    right = parts[rank + 1][:, :h] if rank < size - 1 else zeros
    return torch.cat([left, x, right], dim=1)


def judge(cfg, tr, seed, device, records, kept, group) -> dict:
    """{"answer_rel_err": the largest ||x - x_ref|| / ||x_ref|| of any
    rank's answers' edge rows and whole kept answers}."""
    h, steps = int(cfg["halo"]), int(tr["steps"])
    d = spmd_inputs.band(cfg, seed, group.rank, device).double()
    want = {}
    for k in range(int(tr["pool"])):  # every start block, so every rank gathers alike
        x = spmd_inputs.block(cfg, tr, seed, k, group.rank, device).double()
        for _ in range(steps):
            x = spmd_inputs.product(d, window(x, h, group))
        want[k] = x.cpu()

    def rel(got, ref):
        return float((got.double() - ref).norm() / ref.norm())

    worst = 0.0
    for rec in records:
        if "edges" in rec:
            worst = max(worst, rel(rec["edges"], spmd_inputs.edges(want[rec["blk"]], h, steps)))
    for blk, x in kept.items():
        worst = max(worst, rel(x, want[blk]))
    t = torch.tensor([worst], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.process_group)
    return {"answer_rel_err": t.item()}
