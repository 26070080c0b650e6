"""Driver `expm`: the action expm(t_end A) B at a receiver row, the
reference driver's main path (`test_lanczos.cu`), on the folded-plane
Maxwell operator.  p >= 2: `block_lanczos_expm_action` with the port's
defaults (the fused recurrence: K4 + K2 and S1); p = 1:
`lanczos_expm_action`.  A request takes a start block of the pool and a
receiver lc from the plan, and returns the (p,) answer on the host."""

from __future__ import annotations

from portbench import inputs
from portbench.drivers import load_kernels, maxwell_setup


class Driver:
    def __init__(self, cfg, tr, seed, device, phases):
        with phases("import_port"):
            from lanczos_tpu_torch.methods.expm_action import (
                block_lanczos_expm_action,
                lanczos_expm_action,
            )

        self.p, self.m, self.t_end = int(tr["p"]), int(tr["m"]), float(cfg["t_end"])
        self._action = lanczos_expm_action if self.p == 1 else block_lanczos_expm_action
        load_kernels(device, phases)
        self.op, self.pool = maxwell_setup(cfg, self.p, int(tr["pool"]), seed, device, phases)
        self.plan = inputs.plan(cfg, tr, seed)
        self.records, self.kept = [], {}

    def request(self) -> None:
        blk, lc = self.plan.next()
        sol = self._action(self.op, self.pool[blk], self.m, self.t_end, 0,
                           trace_fn=self.op.trace_fn(lc))
        self.records.append({"blk": blk, "lc": lc,
                             "answer": sol.reshape(-1).cpu().numpy()})

    def free(self) -> None:
        del self.op, self.pool
