"""Test-only control of the `spmd` probe, run as the program: the plain
reference's products (`reference.py`: its halo taken by plain
`torch.distributed`, nothing of the port) in bfloat16, the precision next
below the probe's float32, recorded as the probe's driver records its
answers.  Run through `python -m portbench.run --cell <file>`, its cell
naming it under `"modules": {"drivers": "portbench.tests.spmd.control"}`,
it is judged exactly as the program is, on every rank; a sound
comparison reads it as not correct.  A multi-chip cell's own control is
built the same way, as a new `drivers/<driver>_control.py`."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.tests.spmd import inputs as spmd_inputs
from portbench.tests.spmd.reference import window

LOWER = torch.bfloat16


class Driver:
    def __init__(self, cfg, tr, seed, device, phases, group):
        self.group = group
        self.halo, self.steps = int(cfg["halo"]), int(tr["steps"])
        with phases("inputs"):
            self.band = spmd_inputs.band(cfg, seed, group.rank, device).to(LOWER)
            self.pool = [spmd_inputs.block(cfg, tr, seed, k, group.rank, device).to(LOWER)
                         for k in range(int(tr["pool"]))]
        self.plan = inputs.plan(cfg, tr, seed)
        self.records, self.kept = [], {}

    def request(self) -> None:
        blk, _ = self.plan.next()
        x = self.pool[blk]
        for _ in range(self.steps):
            x = spmd_inputs.product(self.band, window(x, self.halo, self.group))
        self.records.append(
            {"blk": blk, "edges": spmd_inputs.edges(x, self.halo, self.steps).float().cpu()})
        if blk not in self.kept:
            self.kept[blk] = x.float().cpu()

    def free(self) -> None:
        del self.band, self.pool
