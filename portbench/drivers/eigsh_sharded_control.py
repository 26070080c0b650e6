"""The control of the `eigsh_sharded` driver, run as the program: the
plain reference (`reference/eigsh_sharded.py`, plain `torch.distributed`,
nothing of the port) in TF32, the precision next below the
configuration's float32, recording its answers as the driver records the
program's.  Run it through `python -m portbench.run --cell <file>`, the
cell naming it under `"modules": {"drivers":
"portbench.drivers.eigsh_sharded_control"}` (README, "A cell on four
chips"); the harness judges it exactly as it judges the program, and a
sound comparison reads it as not correct."""

from __future__ import annotations

from portbench import inputs, shards
from portbench.reference import eigsh_sharded as ref
from portbench.reference.arith import Arith


class Driver:
    def __init__(self, cfg, tr, seed, device, phases, group):
        self.tr, self.group = tr, group
        self.ar = Arith("tf32")
        with phases("inputs"):
            self.op, self.lo, self.hi = ref.rank_operator(cfg, seed, device, self.ar, group)
            self.pool = [ref.rank_block(cfg, tr, seed, k, device, self.lo, self.hi,
                                        self.op.rows_loc)
                         for k in range(int(tr["pool"]))]
        self.plan = inputs.plan(cfg, tr, seed)
        self.records, self.kept = [], {}

    def request(self) -> None:
        blk, _ = self.plan.next()
        vals, vecs = ref.ritz(self.op, self.pool[blk], int(self.tr["m"]), int(self.tr["k"]),
                              self.ar, self.group, vectors=True)
        res = ref.residuals(self.op, vals, vecs, self.group).double().cpu().numpy()
        self.records.append({"blk": blk, "vals": vals.double().cpu().numpy(), "resid": res})
        if blk not in self.kept:
            self.kept[blk] = (vals, vecs[:, : self.hi - self.lo], res)

    def free(self) -> None:
        rows = shards.probe_rows(self.lo, self.hi, self.op.halo)
        y = self.op.mm(self.pool[0])
        self.kept["apply"] = (rows, y[:, rows.to(y.device) - self.lo].contiguous())
        del self.op, self.pool, y
