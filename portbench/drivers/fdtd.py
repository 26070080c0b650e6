"""Driver `fdtd`: the forward-Euler oracle `fdtd_block` (p = 1:
`fdtd_vector`) on the folded-plane Maxwell operator, K5 replayed from CUDA
graphs.  A request integrates a start block of the pool for the
configuration's `fdtd_steps` steps to its t_end and returns the final state at its receiver lc on the host,
as the CLI's validation reads it; the first final state of each start
block is kept whole for the judge."""

from __future__ import annotations

from portbench import inputs
from portbench.drivers import load_kernels, maxwell_setup


class Driver:
    def __init__(self, cfg, tr, seed, device, phases):
        with phases("import_port"):
            from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector

        self.p, self.steps, self.t_end = int(tr["p"]), int(cfg["fdtd_steps"]), float(cfg["t_end"])
        self._integrate = fdtd_vector if self.p == 1 else fdtd_block
        load_kernels(device, phases)
        self.op, self.pool = maxwell_setup(cfg, self.p, int(tr["pool"]), seed, device, phases)
        self.plan = inputs.plan(cfg, tr, seed)
        self.records, self.kept = [], {}

    def request(self) -> None:
        blk, lc = self.plan.next()
        u = self._integrate(self.op, self.pool[blk], self.steps, self.t_end)
        self.records.append({"blk": blk, "lc": lc,
                             "answer": self.op.trace_fn(lc)(u).reshape(-1).cpu().numpy()})
        if blk not in self.kept:
            self.kept[blk] = u

    def free(self) -> None:
        """Frees the program's state; the kept final states, unpacked to
        the flat (p, n) layout, stay for the judge."""
        self.kept = {k: self.op.unpack(u if self.p > 1 else u[None])
                     for k, u in self.kept.items()}
        del self.op, self.pool
