"""The probe's inputs, made from the seed on the device they are used on,
rank by rank: each rank's rows of the band and of each start block."""

from __future__ import annotations

import torch

from portbench.inputs import generator


def band(cfg: dict, seed: int, rank: int, device) -> torch.Tensor:
    """(2 halo + 1, rows): this rank's rows of the diagonals, offset d of
    row i at [halo + d, i]: the main one in [0.5, 0.6], the others in
    +-0.1 / halo, so a product keeps the norm under about 0.8."""
    h, rows = int(cfg["halo"]), int(cfg["rows"])
    g = generator(seed, device, "spmd-band", rank)
    d = (torch.rand((2 * h + 1, rows), generator=g, device=device) * 2 - 1) * (0.1 / h)
    d[h] = 0.5 + torch.rand(rows, generator=g, device=device) * 0.1
    return d


def block(cfg: dict, tr: dict, seed: int, index: int, rank: int, device) -> torch.Tensor:
    """(p, rows): this rank's rows of start block `index`, N(0, 1)."""
    g = generator(seed, device, "spmd-block", index, rank)
    return torch.randn((int(tr["p"]), int(cfg["rows"])), generator=g, device=device)


def product(d: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """A x on this rank's rows from `window`, its block with `halo` rows
    of each neighbour's on either side (zeros past the ends)."""
    h, rows = (d.shape[0] - 1) // 2, d.shape[1]
    out = d[h] * window[:, h:h + rows]
    for k in range(2 * h + 1):
        if k != h:
            out = out + d[k] * window[:, k:k + rows]
    return out


def edges(x: torch.Tensor, halo: int, steps: int) -> torch.Tensor:
    """(p, 2 e): the first and last e = min(rows, 2 halo steps) rows of a
    rank's answer, those the neighbours' rows reach in `steps` products."""
    e = min(x.shape[1], 2 * halo * steps)
    return torch.cat([x[:, :e], x[:, -e:]], dim=1)
