"""Test-only driver: the `eigsh_sharded` driver with one planted fault in
its halo exchange, named by the traffic's "fault":

- "spikes": each rank drops (zeroes) the halo rows it receives that hold
  one of the band's spikes.  The top of this band's spectrum is its
  spikes, so this fault moves the Ritz pairs; it drops nothing where no
  spike lies in a halo, as at the cell's full size;
- "row": each rank drops the one halo row next to each edge of its
  shard, rows lo - 1 and hi, as an exchange that loses a row would;
- "exchange": every halo slot is left zero, as if no exchange ran;
- "stale": every halo slot holds what the previous product of the same
  width received, as a strip whose halo is written in place and whose
  exchange was skipped would.

The last three leave the Ritz pairs as they were, to float32's rounding,
wherever no spike lies near a shard edge; the judge's check of the
operator's own product (`apply_rel_err`) must find them.  Run as the
program through `--cell` (`test_portbench_sharded.py`, and on four cards
at the cell's full size), each must read as not correct."""

from __future__ import annotations

import dataclasses

import torch

from lanczos_tpu_torch.parallel.mesh import Mesh

from portbench import inputs
from portbench.drivers import eigsh_sharded


@dataclasses.dataclass(frozen=True)
class FaultyMesh(Mesh):
    """A mesh whose halo strips carry `fault`; `dropped`: the slots the
    "spikes" and "row" faults zero."""

    fault: str = "row"
    dropped: tuple = ()
    last: dict = dataclasses.field(default_factory=dict, compare=False, hash=False)

    def halo_strip(self, x, offset, rows, halo):
        work = super().halo_strip(x, offset, rows, halo)
        left, right = slice(offset - halo, offset), slice(offset + rows, offset + rows + halo)
        if self.fault == "exchange":
            work[:, left] = 0
            work[:, right] = 0
        elif self.fault == "stale":
            fresh = (work[:, left].clone(), work[:, right].clone())
            old = self.last.get(tuple(work.shape))
            if old is not None:
                work[:, left], work[:, right] = old
            self.last[tuple(work.shape)] = fresh
        else:
            work[:, list(self.dropped)] = 0
        return work


class Driver(eigsh_sharded.Driver):
    def __init__(self, cfg, tr, seed, device, phases, group):
        super().__init__(cfg, tr, seed, device, phases, group)
        fault = tr.get("fault", "spikes")
        op = self.op
        lo, h, rl = self.lo, op.halo, op.rows_loc
        if fault == "spikes":
            _, diag = inputs.banded_diagonals(cfg, int(cfg["rows"]), seed, device)
            spikes = torch.nonzero(diag > min(cfg["spikes"])).flatten().tolist()
            del diag
            # a spike row g in this rank's halo: left [lo - h, lo), right [lo + rl, lo + rl + h)
            slots = [op.offset - (lo - g) for g in spikes if lo - h <= g < lo]
            slots += [op.offset + g - lo for g in spikes if lo + rl <= g < lo + rl + h]
        elif fault == "row":
            slots = [op.offset - 1, op.offset + rl]
        elif fault in ("exchange", "stale"):
            slots = []
        else:
            raise ValueError(f"no fault {fault!r}")
        self.dropped = slots
        m = op.mesh
        op.mesh = FaultyMesh(m.rank, m.size, m.device, m.group, fault, tuple(slots))
