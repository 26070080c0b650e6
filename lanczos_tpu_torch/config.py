"""Run configuration (port of `lanczos_tpu/config.py`, plus `device`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LanczosConfig:
    # problem
    n_grid: int = 10          # reference -N (Maxwell grid size)
    m: int = 5                # reference -m (Lanczos iterations)
    block: bool = True        # block vs single-vector (use_block)
    n_col: int = 4            # block width (reference N_COL macro)
    t_end: float = 1.0
    fdtd_steps: int = 1_000_000
    lc: int | None = None     # receiver index; None -> randomized 1..100
    seed: int = 0

    # numerics
    dtype: str = "float32"
    reorth: str = "none"      # none | full | selective (vector) / periodic
    eig_backend: str = "jacobi"  # small eigensolver: jacobi | lax | newton
    breakdown_tol: float = 0.0
    normalize: str = "sqrtm"  # sqrtm (reference) | qr (TSQR, rank-safe)
    breakdown_eps: float = 0.0  # rank-revealing deflation threshold
    replace_dead: bool = False  # adaptive restart of collapsed directions
    fused: bool | None = None   # None=auto: traffic-minimal fused recurrence
    compensated: bool = False   # error-free-transform Gram accumulation

    # execution
    operator: str = "stencil"  # stencil | pallas | ell
    devices: int = 1           # >1: z-sharded distributed operator
    validate: bool = True      # run the FDTD oracle comparison
    profile_dir: str | None = None  # capture a profiler trace here
    device: str = "cuda"       # torch device of the state and operator
