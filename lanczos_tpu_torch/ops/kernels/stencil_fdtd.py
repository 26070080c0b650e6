"""K5: one forward-Euler FDTD step, out = u + (dt A) u, in one pass.

Port of `fdtd_step_inplace` (lanczos_tpu/ops/pallas/stencil_fdtd.py:50).
dt is folded into the z-weights by the caller (`PallasMaxwellOperator.
scaled`), so the step is the curl-pair stencil plus the identity term: one
read and one write of the state, against five passes for K1 followed by a
separate add.

The Pallas kernel updates u in its own buffer: the TPU runs its grid steps
in order, and a VMEM delay ring keeps the rows its neighbours still need.
CUDA blocks run in no order, so an in-place update would let one block
overwrite the z-halo rows and +-xc lanes another block still reads.  This
step writes into a second buffer instead (ping-pong; `methods/fdtd.py`
swaps the two): the same bytes, one more state of memory.  The Pallas
plan's VMEM gate (p <= 2, f32 only) is a TPU limit and is not ported:
the step takes every p and both float types the operator takes, and
paired or unpaired halves, as the Pallas kernel does (an unpaired half
sums its taps one at a time, (v * wp) * wz in spec order).

On a CUDA tensor `fdtd_step` launches fdtd_step_kernel of
`csrc/lanczos_kernels.cu`, K1's strip kernel with the identity term
(`stencil_kernel.launch_pair`); on a CPU tensor it runs `fdtd_step_plain`.
A step checks its tensors and reuses the cached tap table and plan.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    StencilSpec,
    apply_stencil_pair_plain,
    check_geometry,
    launch_pair,
)


def fdtd_step_plain(u, out, wz_t, wplane, spec_a, spec_b):
    """Plain torch version (same contract): out = u + A u."""
    return out.copy_(u + apply_stencil_pair_plain(u, wz_t, wplane, spec_a, spec_b))


def fdtd_step(
    u: torch.Tensor,
    out: torch.Tensor,
    wz_t: torch.Tensor,
    wplane: torch.Tensor,
    spec_a: StencilSpec,
    spec_b: StencilSpec,
) -> torch.Tensor:
    """out = u + A u for u, out (p, 6, Zc, P), A the curl pair of the
    (dt-scaled) weights.  out must be another buffer than u; returns out.
    Either half may be paired or not."""
    if u.ndim != 4 or u.shape != out.shape:
        raise ValueError(
            f"u/out must be (p,6,Zc,P), got {tuple(u.shape)}/{tuple(out.shape)}"
        )
    if u.data_ptr() == out.data_ptr():
        raise ValueError(
            "fdtd_step writes into a second buffer: out must not be u "
            "(neighbouring positions still read u)"
        )
    if u.device.type == "cpu":
        return fdtd_step_plain(u, out, wz_t, wplane, spec_a, spec_b)
    build.require_cuda("fdtd_step", u, out, wz_t, wplane)
    nt = check_geometry(u, wz_t, wplane, spec_a)
    launch_pair("fdtd_step", "lt_fdtd_step", u, out, wz_t, wplane, spec_a,
                spec_b, nt)
    return out
