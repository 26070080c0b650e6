"""Driver `eigsh_sharded`: the `eigsh` driver's request on a matrix whose
rows are split over the ranks of a cell on several cards, through the
port's sharded path: `HaloShardedWindowed` (a rank's rows as a
windowed-ELL plan, K8 after a halo exchange) built by
`halo_sharded_windowed_rows` from the rank's own rows alone, then
`block_lanczos_eigsh` and `ritz_residuals` on the port's `Mesh` over the
harness's group.

Each rank makes the band's diagonals from the seed on its card, keeps its
rows (`portbench/shards.py`) and plans them; no rank holds the whole
matrix.  The start blocks are drawn whole (`inputs.banded_block`) and
each rank keeps its rows.  A request returns the Ritz values and measured
residuals on the host, the same on every rank; the first Ritz vectors of
each start block are kept, each rank its rows, for the judge, and so is
one product of the timed operator: its rows `shards.probe_rows` of A
times start block 0, the rows next to each shard edge among them, which
only a sound halo exchange gets right."""

from __future__ import annotations

import torch

from portbench import inputs, shards
from portbench.drivers import load_kernels


class Driver:
    def __init__(self, cfg, tr, seed, device, phases, group):
        with phases("import_port"):
            from lanczos_tpu_torch import native
            from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
            from lanczos_tpu_torch.parallel.dist_windowed import halo_sharded_windowed_rows
            from lanczos_tpu_torch.parallel.mesh import Mesh

        self._eigsh, self._residuals = block_lanczos_eigsh, ritz_residuals
        self.tr = tr
        mesh = Mesh(group.rank, group.size, device, group.process_group)
        load_kernels(device, phases)
        with phases("host_engine"):
            native.library()
        n = int(cfg["rows"])
        self.lo, self.hi, rows_loc = shards.bounds(n, group.size, group.rank)
        with phases("inputs"):
            upper, diag = inputs.banded_diagonals(cfg, n, seed, device)
            coef = shards.rank_diagonals(upper, diag, self.lo, self.hi)
            del upper, diag
            rows = shards.rows_csr(coef, self.lo, self.hi, n)
            del coef
        with phases("plan"):
            self.op = halo_sharded_windowed_rows(rows, n, mesh,
                                                 dtype=getattr(torch, cfg["dtype"]))
            del rows
        if self.op.rows_loc != rows_loc:
            raise RuntimeError(f"the port holds {self.op.rows_loc} rows a rank, "
                               f"the harness {rows_loc}")
        with phases("inputs"):
            self.pool = [self.op.pad_vector(inputs.banded_block(n, int(tr["p"]), seed, k, device))
                         for k in range(int(tr["pool"]))]
        self.plan = inputs.plan(cfg, tr, seed)
        self.records, self.kept = [], {}

    def request(self) -> None:
        blk, _ = self.plan.next()
        tr = self.tr
        vals, vecs, _ = self._eigsh(
            self.op, self.pool[blk], int(tr["m"]), int(tr["k"]), which=tr["which"],
            reorth=tr["reorth"], normalize=tr["normalize"],
            breakdown_eps=float(tr["breakdown_eps"]), replace_dead=bool(tr["replace_dead"]),
            eig_backend=tr["eig_backend"], compute_vectors=True)
        resid = self._residuals(self.op, vals, vecs)
        host = torch.stack([vals, resid]).double().cpu().numpy()
        self.records.append({"blk": blk, "vals": host[0], "resid": host[1]})
        if blk not in self.kept:
            self.kept[blk] = (vals, vecs, host[1])

    def free(self) -> None:
        """Frees the program's state; the kept Ritz pairs, each rank's rows
        (k, hi - lo) of the vectors, stay for the judge, and under "apply"
        (rows, their (p, rows.numel()) values of A b) one product of start
        block 0, made here on every rank."""
        at = self.op.offset
        self.kept = {k: (v, x[at : at + self.hi - self.lo].T.contiguous(), r)
                     for k, (v, x, r) in self.kept.items()}
        rows = shards.probe_rows(self.lo, self.hi, self.op.halo)
        y = self.op.mm(self.pool[0])
        self.kept["apply"] = (rows, y[:, at + rows.to(y.device) - self.lo].contiguous())
        del y
        del self.op, self.pool
