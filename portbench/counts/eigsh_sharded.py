"""Least traffic of one `eigsh_sharded` request on one rank: the `eigsh`
count (`counts/eigsh.py`) at the rank's rows_loc rows, with what sharding
adds to it.

An interior rank's rows hold the whole band: besides the entries of a
band of rows_loc rows, those that reach into the neighbours' rows, 2
sum(offsets) more values, read by each product.  Each product also
brings in the halo: `halo` rows of the neighbours' state on each side,
for each of its columns (m products of p columns, then the residuals' of
k).  The p x p collectives move no bytes that count here."""

from __future__ import annotations

from portbench import shards
from portbench.counts import eigsh
from portbench.counts.expm import ITEMSIZE
from portbench.inputs import banded_offsets


def request(cfg: dict, tr: dict) -> dict:
    n, ranks = int(cfg["rows"]), int(cfg["deployment"]["ranks"])
    p, m, k = int(tr["p"]), int(tr["m"]), int(tr["k"])
    item = ITEMSIZE[cfg["dtype"]]
    _, _, rows_loc = shards.bounds(n, ranks, 0)
    base = eigsh.request(dict(cfg, rows=rows_loc), tr)
    offsets = banded_offsets(cfg, n)
    reach, halo = 2 * sum(offsets), max(offsets)
    columns = m * p + k  # the columns of every product of a request
    return {"bytes": base["bytes"] + (m + 1) * reach * item + columns * 2 * halo * item,
            "flops": base["flops"] + 2 * reach * columns}
