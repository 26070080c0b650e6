"""One distributed block-Lanczos step of each multi-device path on N ranks
(the counterpart of `__graft_entry__.dryrun_multichip`).

    python -m lanczos_tpu_torch.parallel.dryrun N [--device cpu]

Every rank runs `dryrun_rank` (`__graft_entry__.py:100-149`'s three
steps) on its mesh: block Lanczos on the z-slab `DistributedPallasMaxwell`
(4 x 4 x 4, p=4, m=3, reorth full, the newton sqrtm, breakdown_tol 1e-6);
`block_lanczos_eigsh` (m=3, k=2) on the halo ELL of a 16 x 3N Laplacian;
and the same eigsh, from the same start block, on its `HaloShardedWindowed`
with the sharded TSQR (normalize "qr", breakdown_eps 1e-6, replace_dead).
The outputs must be finite, and the two top Ritz values agree to 1e-2
relative: the m=3 Krylov spaces coincide.

JAX's guard against GSPMD's "Involuntary full rematerialization" has no
counterpart: no compiler decides here where a state lives, and a rank
holds only its shard by construction.  In its place each rank asserts
that its start blocks and their products have its shard's shape.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

P, M = 4, 3
RITZ_RTOL = 1e-2


def dryrun_rank(mesh) -> dict:
    """The three steps on this rank's mesh; their outputs, the same on
    every rank but the z-slab trace's owner."""
    from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
    from lanczos_tpu_torch.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu_torch.models.laplacian import laplacian_2d_scipy
    from lanczos_tpu_torch.models.rhs import gaussian_matrix_B
    from lanczos_tpu_torch.parallel import (
        DistributedPallasMaxwell,
        halo_sharded_ell,
        halo_sharded_windowed,
    )

    def shard_shaped(op, b):
        want = (P,) + tuple(op.state_shape)
        if tuple(b.shape) != want or tuple(op.mm(b).shape) != want:
            raise AssertionError(f"rank {mesh.rank}: a state of {tuple(b.shape)}, "
                                 f"not its shard's {want}")

    dop = DistributedPallasMaxwell.create(4, 4, 4, mesh, dtype=torch.float32)
    B = dop.pack(torch.from_numpy(gaussian_matrix_B(4, dop.n, P).astype(np.float32)))
    shard_shaped(dop, B)
    res = block_lanczos(dop, B, M, reorth="full", trace_fn=dop.trace_fn(7),
                        eig_backend="newton", breakdown_tol=1e-6)

    a = laplacian_2d_scipy(16, 3 * mesh.size)
    x = np.random.default_rng(0).standard_normal((P, a.shape[0])).astype(np.float32)
    op = halo_sharded_ell(a, mesh)
    b = op.pad_vector(x)
    shard_shaped(op, b)
    vals, _, _ = block_lanczos_eigsh(op, b, M, 2, which="LA")

    opw = halo_sharded_windowed(a, mesh, cpb=2, spg=2)
    bw = opw.pad_vector(x)
    shard_shaped(opw, bw)
    vals_w, _, _ = block_lanczos_eigsh(opw, bw, M, 2, which="LA", normalize="qr",
                                       breakdown_eps=1e-6, replace_dead=True)
    out = {"alphas": res.alphas, "trace": res.trace, "vals": vals, "vals_w": vals_w}
    if not all(bool(torch.isfinite(t).all()) for t in out.values()):
        raise AssertionError(f"rank {mesh.rank}: a result is not finite: {out}")
    top, top_w = float(vals[0]), float(vals_w[0])
    if not abs(top_w - top) < RITZ_RTOL * max(1.0, abs(top)):
        raise AssertionError(f"rank {mesh.rank}: windowed top Ritz {top_w} against "
                             f"the halo ELL's {top}")
    return out


def dryrun_multichip(n: int, device="cuda") -> list:
    """`dryrun_rank` on n ranks (one a card, NCCL; or gloo with
    device="cpu"); the ranks' results."""
    from lanczos_tpu_torch.parallel import launch

    ranks = launch.run(dryrun_rank, n, device=device, timeout=600)
    print(f"dryrun_multichip({n}): distributed stencil + ELL + windowed-ELL "
          f"(qr-TSQR) block Lanczos over {n} {torch.device(device).type} rank(s) "
          f"ok; top Ritz ~ {float(ranks[0]['vals'][0]):.4f}", flush=True)
    return ranks


def main(argv=None):
    from lanczos_tpu_torch.benchmarks import add_device_argument, resolve_device

    ap = argparse.ArgumentParser(prog="python -m lanczos_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: every card, or 2 with --device cpu)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    n = args.n or (torch.cuda.device_count() if device == "cuda" else 2)
    return dryrun_multichip(n, device)


if __name__ == "__main__":
    main()
