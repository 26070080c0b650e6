"""The control of a cell's comparison: the plain reference, computed in
TF32 (the nearest precision below the configurations' float32 with TF32
off), put in the program's place and judged exactly as a run judges the
program.  A sound comparison reads it as not correct.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--requests R]

One JSON line a seed: the readings beside the cell's limits and whether
the control fails them.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import inputs
from portbench.run import load_cell


def plan_records(cell: dict, seed: int, requests: int) -> list:
    """The first `requests` requests of a run with this seed."""
    plan = inputs.plan(cell["config"], cell["traffic"], seed)
    out = []
    for _ in range(requests):
        blk, lc = plan.next()
        out.append({"blk": blk, "lc": lc})
    return out


def control_readings(cell: dict, seed: int, requests: int, device) -> dict:
    import importlib

    reference = importlib.import_module(f"portbench.reference.{cell['traffic']['driver']}")
    cfg, tr = cell["config"], cell["traffic"]
    records, kept = reference.control(cfg, tr, seed, device, plan_records(cell, seed, requests))
    return reference.judge(cfg, tr, seed, device, records, kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    for seed in args.seeds:
        readings = control_readings(cell, seed, args.requests, dev)
        fails = any(readings[k] > v for k, v in cell["limits"].items())
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": readings,
                          "limits": cell["limits"], "control_fails": fails}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
