"""Test-only driver `spmd`: `steps` products with the probe's band, each
after a halo exchange through the port's `Mesh` (`halo_window`).  A
request takes a start block of the pool and keeps on the host the rows of
its answer that a halo reaches (`spmd_inputs.edges`), and the first answer
of each start block whole.  `steps` 0 makes a request that does no work at all,
so its time is the harness's own a request (the go/stop broadcast).

Each of the configuration's `faults`, {"rank", "kind", "request"},
plants one fault on that rank from that request on (warm-up requests
count): `raise` raises, `exit` ends the process, `hang` stops answering,
`jax` puts a module named jax into sys.modules, and `no_exchange` drops
what the neighbours sent (the exchange still runs, so no neighbour
waits)."""

from __future__ import annotations

import os
import sys
import time
import types

import torch.nn.functional as F

from portbench import inputs
from portbench.tests.spmd import inputs as spmd_inputs


class Driver:
    def __init__(self, cfg, tr, seed, device, phases, group):
        from lanczos_tpu_torch.parallel.mesh import Mesh

        self.mesh = Mesh(group.rank, group.size, device, group.process_group)
        self.halo, self.steps = int(cfg["halo"]), int(tr["steps"])
        with phases("inputs"):
            self.band = spmd_inputs.band(cfg, seed, group.rank, device)
            self.pool = [spmd_inputs.block(cfg, tr, seed, k, group.rank, device)
                         for k in range(int(tr["pool"]))]
        self.plan = inputs.plan(cfg, tr, seed)
        self.faults = {f["kind"]: int(f["request"]) for f in cfg.get("faults", [])
                       if f["rank"] == group.rank}
        self.count = 0
        self.records, self.kept = [], {}

    def _planted(self, kind: str) -> bool:
        return kind in self.faults and self.count >= self.faults[kind]

    def request(self) -> None:
        self.count += 1
        if self._planted("jax"):
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        if self._planted("raise"):
            raise RuntimeError("a planted fault")
        if self._planted("exit"):
            os._exit(7)
        if self._planted("hang"):
            time.sleep(3600)
        blk, _ = self.plan.next()
        if not self.steps:
            self.records.append({"blk": blk})
            return
        x = self.pool[blk]
        for _ in range(self.steps):
            window = self.mesh.halo_window(x, self.halo)
            if self._planted("no_exchange"):
                window = F.pad(x, (self.halo, self.halo))
            x = spmd_inputs.product(self.band, window)
        self.records.append(
            {"blk": blk, "edges": spmd_inputs.edges(x, self.halo, self.steps).cpu()})
        if blk not in self.kept:
            self.kept[blk] = x.cpu()

    def free(self) -> None:
        del self.band, self.pool
