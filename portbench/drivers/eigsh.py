"""Driver `eigsh`: the top-k eigenpairs of an assembled sparse matrix with
certified residuals, as the port's assembled slice runs them: the
windowed-ELL plan (`windowed_from_scipy`, reorder "none"; its product is
K8) behind `PaddedWindowedOperator`, `block_lanczos_eigsh` with the
traffic's options and `compute_vectors`, then `ritz_residuals`.  A request
takes a start block of the pool and returns its Ritz values and measured
residuals on the host; the first Ritz vectors of each start block are
kept for the judge."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.drivers import load_kernels


class Driver:
    def __init__(self, cfg, tr, seed, device, phases):
        with phases("import_port"):
            from lanczos_tpu_torch import native
            from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh, ritz_residuals
            from lanczos_tpu_torch.ops.window_ell import (
                PaddedWindowedOperator,
                windowed_from_scipy,
            )

        self._eigsh, self._residuals = block_lanczos_eigsh, ritz_residuals
        self.tr = tr
        load_kernels(device, phases)
        with phases("host_engine"):
            native.library()
        self.n = n = int(cfg["rows"])
        with phases("inputs"):
            upper, diag = inputs.banded_diagonals(cfg, n, seed, device)
            a = inputs.banded_csr(upper, diag)
            del upper, diag
        with phases("plan"):
            base = windowed_from_scipy(a, dtype=getattr(torch, cfg["dtype"]),
                                       reorder="none", device=device)
            del a
            self.op = PaddedWindowedOperator(base)
        with phases("inputs"):
            self.pool = [base.pack(inputs.banded_block(n, int(tr["p"]), seed, k, device))
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
        """Frees the program's state; the kept Ritz pairs, as (k, n) rows
        in the matrix's natural order, stay for the judge."""
        self.kept = {k: (v, x[: self.n].T.contiguous(), r)
                     for k, (v, x, r) in self.kept.items()}
        del self.op, self.pool
