"""Benchmark drivers of the port (port of the repository's `benchmarks/`).

    python -m lanczos_tpu_torch.benchmarks.kernel_bench [--only a,b] [--json PATH]
    python -m lanczos_tpu_torch.benchmarks.sweep_lanczos [--vector] [--sweep-ncol]
    python -m lanczos_tpu_torch.benchmarks.convergence [--block] [--csv PATH]
    python -m lanczos_tpu_torch.benchmarks.suitesparse_scale [--rows N] [--json PATH]
    python -m lanczos_tpu_torch.benchmarks.weak_scaling [--devices 1 2 4] [--json PATH]

Each runs on the card (`--device cuda`, the default) and raises
RuntimeError without one; `--device cpu` runs it on the CPU (the tests).
They print their rows to stdout and write a file only when given a path.

The helpers here are what more than one driver uses.
"""

from __future__ import annotations

import json

import torch

# the smallest state a copy-rate measurement streams: one far above the
# card's 50 MB L2, so that the rate is the device memory's
COPY_MIN_BYTES = 384 * 1024 * 1024


def add_device_argument(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")


def resolve_device(name: str) -> torch.device:
    """The driver's device: "cuda" without a card raises RuntimeError."""
    from lanczos_tpu_torch.ops.operator import target_device

    return target_device(name)


def copy_rate(like: torch.Tensor, min_bytes: int = COPY_MIN_BYTES) -> float:
    """Same-window copy rate in GB/s (one read and one write counted): the
    chained y <- 1 - y on a state of like's dtype and device of at least
    `min_bytes` (tiled from like), so that no run of it fits in cache."""
    from lanczos_tpu_torch.utils.bench_loop import slope_time_chain

    reps = max(1, -(-min_bytes // (like.numel() * like.element_size())))
    big = like if reps == 1 else like.reshape(-1).repeat(reps)
    s = slope_time_chain(lambda y: 1.0 - y, big, damp=None)
    return 2 * big.numel() * big.element_size() / s / 1e9


def format_row(row: dict) -> str:
    return "  ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in row.items())


def write_json(path: str | None, obj) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        print(f"wrote {path}", flush=True)
