"""Cells cut to a size the CPU tests can hold: Maxwell at N=8 with t_end
scaled so that ||t A|| stays what it is at N=160 (||A|| falls as
(N+1)^-2), and the banded matrix at 12,000 rows."""

from __future__ import annotations

from portbench.run import load_cell

MAXWELL_N = 8
BANDED_ROWS = 12000


def tiny_cell(name: str, n_grid: int = MAXWELL_N, rows: int = BANDED_ROWS) -> dict:
    cell = load_cell(name)
    cfg = cell["config"]
    if cfg["kind"] == "maxwell":
        cfg.update(n_grid=n_grid, t_end=cfg["t_end"] * ((n_grid + 1) / 161) ** 2,
                   lc_range=[1, 20])
    else:
        cfg.update(rows=rows)
    return cell
