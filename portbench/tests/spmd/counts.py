"""Least traffic of one `spmd` request on one rank: each step reads the
rank's block and band once and writes its answer; 2 operations a stored
value and column."""

from __future__ import annotations

from portbench.counts.expm import ITEMSIZE


def request(cfg: dict, tr: dict) -> dict:
    rows, diags = int(cfg["rows"]), 2 * int(cfg["halo"]) + 1
    p, steps = int(tr["p"]), int(tr["steps"])
    item = ITEMSIZE[cfg["dtype"]]
    return {"bytes": steps * (2 * rows * p + diags * rows) * item,
            "flops": steps * 2 * diags * rows * p}
