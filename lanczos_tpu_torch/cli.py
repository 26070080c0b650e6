"""CLI driver — the reference's `test_lanczos.cu` main on PyTorch/CUDA.

    python -m lanczos_tpu_torch --operator pallas -N 160 -m 6 --block --n-col 4
    python -m lanczos_tpu_torch --operator pallas -N 160 -m 8 --vector
    python -m lanczos_tpu_torch -N 3 -m 8 --vector --reorth full --device cpu

Builds the 3-D Maxwell fixture, runs single-vector or block Lanczos,
propagates the matrix exponential to the receiver index, and validates
against the forward-Euler FDTD oracle (reference `test_lanczos.cu:21-305`).
Same flags as `python -m lanczos_tpu`, plus `--device` (default cuda; a
device that is not there is an error).  `--operator pallas` is the
folded-plane stencil the CUDA kernels serve; `--operator stencil` (the
default) the flat-state `MaxwellOperator` in plain torch; `--operator
ell` the assembled A as gathered ELL in plain torch (in `--dtype`: the
JAX package builds it in f32 whatever `--dtype` says).  `--profile DIR`
wraps the Lanczos run, and only it, in `torch.profiler` (CPU activity,
and CUDA activity on the card) and writes a Chrome trace,
DIR/lanczos_trace.json, even when the run raises.  Not ported yet, and
raising NotImplementedError naming its ROADMAP item: `--devices > 1`.
`--vector --compensated` is a ValueError: the compensated Gram is a
block-path option.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import time

from lanczos_tpu_torch.config import LanczosConfig

TRACE_FILE = "lanczos_trace.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lanczos_tpu_torch",
        description="PyTorch/CUDA single/block Lanczos expm-action driver",
    )
    ap.add_argument("-N", "--n-grid", type=int, default=10)
    ap.add_argument("-m", "--iterations", type=int, default=5)
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--block", action="store_true", default=True)
    g.add_argument("--vector", dest="block", action="store_false")
    ap.add_argument("--n-col", type=int, default=4)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--fdtd-steps", type=int, default=1_000_000)
    ap.add_argument("--lc", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--reorth", default="none",
                    choices=["none", "full", "selective", "periodic"])
    ap.add_argument("--eig-backend", default="jacobi",
                    choices=["jacobi", "lax", "newton"])
    ap.add_argument("--normalize", default="sqrtm", choices=["sqrtm", "qr"])
    ap.add_argument("--breakdown-eps", type=float, default=0.0,
                    help="rank-revealing deflation threshold (relative "
                         "eigenvalue cutoff)")
    ap.add_argument("--replace-dead", action="store_true")
    ap.add_argument("--breakdown-tol", type=float, default=0.0,
                    help="freeze the recurrence once the beta-block rcond "
                         "estimate falls below this; 0 disables")
    ap.add_argument("--operator", default="stencil",
                    choices=["stencil", "pallas", "ell"])
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=None,
                    help="force the materialized (reference-semantics) "
                         "recurrence instead of the traffic-minimal fused "
                         "path")
    ap.add_argument("--compensated", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--no-validate", dest="validate", action="store_false")
    ap.add_argument("--profile", dest="profile_dir", metavar="DIR",
                    default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the operator and states")
    return ap


def config_from_args(args) -> LanczosConfig:
    return LanczosConfig(
        n_grid=args.n_grid, m=args.iterations, block=args.block,
        n_col=args.n_col, t_end=args.t_end, fdtd_steps=args.fdtd_steps,
        lc=args.lc, seed=args.seed, dtype=args.dtype, reorth=args.reorth,
        eig_backend=args.eig_backend,
        breakdown_tol=args.breakdown_tol, normalize=args.normalize,
        breakdown_eps=args.breakdown_eps, replace_dead=args.replace_dead,
        fused=args.fused, compensated=args.compensated,
        operator=args.operator,
        devices=args.devices, validate=args.validate,
        profile_dir=args.profile_dir, device=args.device,
    )


def _check_ported(cfg: LanczosConfig) -> None:
    if not cfg.block and cfg.compensated:
        raise ValueError(
            "--compensated is a block-Lanczos option (the compensated Gram); "
            "--vector has no Gram to compensate"
        )
    if cfg.devices > 1:
        raise NotImplementedError(
            "--devices > 1 (multi-device operators) is not ported to "
            "lanczos_tpu_torch yet (ROADMAP Queue 1 item 12)"
        )


def _profiler(profile_dir: str | None, device):
    """torch.profiler over CPU activity, plus CUDA activity on the card,
    writing DIR/lanczos_trace.json when the block exits (an exception
    included); a null context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    def write(prof):
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities, on_trace_ready=write)


def run(cfg: LanczosConfig) -> dict:
    import numpy as np
    import torch

    from lanczos_tpu_torch.methods.expm_action import (
        block_lanczos_expm_action,
        lanczos_expm_action,
    )
    from lanczos_tpu_torch.methods.fdtd import fdtd_block, fdtd_vector
    from lanczos_tpu_torch.models.maxwell import (
        MaxwellOperator,
        maxwell_ell_operator,
    )
    from lanczos_tpu_torch.models.maxwell_pallas import PallasMaxwellOperator
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B, gaussian_vector_b
    from lanczos_tpu_torch.ops.operator import target_device

    _check_ported(cfg)
    device = target_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_grid = cfg.n_grid
    if cfg.operator == "pallas":
        op = PallasMaxwellOperator.create(n_grid, n_grid, n_grid,
                                          dtype=dtype, device=device)
        pack, unpack = op.pack, op.unpack
    else:  # the flat state needs no packing and no trace_fn
        if cfg.operator == "ell":
            op = maxwell_ell_operator(n_grid, n_grid, n_grid, dtype=dtype,
                                      device=device)
        else:
            op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=dtype,
                                        device=device)
        pack = unpack = lambda x: x  # noqa: E731
    n = op.shape[0]
    rng = random.Random(cfg.seed)
    lc = cfg.lc if cfg.lc is not None else 1 + rng.randrange(100)
    out = {"n": n, "lc": lc, "m": cfg.m, "block": cfg.block,
           "operator": cfg.operator, "device": str(device)}
    # the receiver: a trace_fn on the folded-plane state, index lc on the flat one
    if cfg.operator == "pallas":
        receiver = dict(lc=0, trace_fn=op.trace_fn(lc))
    else:
        receiver = dict(lc=lc)

    sync()
    t0 = time.perf_counter()
    with _profiler(cfg.profile_dir, device):  # written even if the run raises
        if cfg.block:
            b_np = gaussian_matrix_B(n_grid, n, cfg.n_col)
        else:
            b_np = gaussian_vector_b(n_grid, n)
        b = pack(torch.from_numpy(b_np.astype(cfg.dtype)).to(device))
        del b_np
        if cfg.block:
            sol = block_lanczos_expm_action(
                op, b, cfg.m, cfg.t_end, **receiver, reorth=cfg.reorth,
                eig_backend=cfg.eig_backend, breakdown_tol=cfg.breakdown_tol,
                normalize=cfg.normalize, breakdown_eps=cfg.breakdown_eps,
                replace_dead=cfg.replace_dead, fused=cfg.fused,
                compensated=cfg.compensated,
            )
        else:
            sol = lanczos_expm_action(
                op, b, cfg.m, cfg.t_end, **receiver,
                reorth="none" if cfg.reorth == "periodic" else cfg.reorth,
                breakdown_tol=cfg.breakdown_tol, fused=cfg.fused,
            )
        sol = sol.cpu().numpy()  # waits for the device
    out["lanczos_seconds"] = time.perf_counter() - t0
    if cfg.profile_dir:
        out["profile_dir"] = cfg.profile_dir
    out["solution"] = sol.tolist()

    if cfg.validate:
        sync()
        t0 = time.perf_counter()
        if cfg.block:
            u = fdtd_block(op, b, cfg.fdtd_steps, cfg.t_end)
            ref = unpack(u)[:, lc].cpu().numpy()
        else:
            u = fdtd_vector(op, b, cfg.fdtd_steps, cfg.t_end)
            ref = unpack(u)[lc].cpu().numpy()
        rel = float(np.linalg.norm(sol - ref) / np.linalg.norm(ref))
        out["fdtd_seconds"] = time.perf_counter() - t0
        out["relative_error"] = rel
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(config_from_args(args))
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
