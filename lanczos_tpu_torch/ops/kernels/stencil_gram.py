"""K4: the fused stencil + Gram pass with destination aliasing.

Port of `apply_stencil_pair_gram` (lanczos_tpu/ops/pallas/
stencil_gram.py:96), the second call of the fused iteration's "mono"
step (`methods/block_lanczos_fused.py`).  One pass computes

    v  = A @ q                                   written into dst
    g3 = [gram(q, v); gram(v, v); gram(dst, q)]  (3p, p)

In the recurrence dst is v_{j-1}, dead after this call, and gram(dst, q)
is the m13 Gram block the deferred-Gram algebra needs next.  The CUDA
kernel reads each dst element before it writes v there, and takes the
stencil's neighbour reads from q only, so the in-place write races with
nothing.  The returned v is dst itself.

The Pallas version's lane-chunk/halo/VMEM planning is a TPU artifact and
is not ported.  The kernel's own launch comes from
`stencil_kernel.pair_gram_plan`: strips of lanes marching along z with
row z of every block column staged in shared memory, z-taps read at the
thread's own lane (so a z-tap that rolls is refused), the Gram summed
over the grid in one launch whose last block adds the blocks' partials in
block order (K3's ticket).  A paired half takes the factored form, an
unpaired half sums its taps one at a time, in the same launch.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.block_dense import _ticket, gram_plain
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    GRAM_MAX_P,
    StencilSpec,
    apply_stencil_pair_plain,
    check_geometry,
    pair_gram_plan,
    tap_table,
)

MAX_P = GRAM_MAX_P  # csrc stencil_gram_kernel instantiations (registers: 3 p^2 sums)


def supports(p: int, dtype: torch.dtype) -> bool:
    """Whether the fused recurrence routes p block columns of this dtype
    through the fused pass: f32 (as the Pallas plan; no bf16) and p <=
    MAX_P (the kernel keeps 3 p^2 Gram sums per thread in registers)."""
    return dtype == torch.float32 and 1 <= p <= MAX_P


def apply_stencil_pair_gram_plain(q, dst, wz_t, wplane, spec_a, spec_b):
    """Plain torch version (same contract)."""
    v = apply_stencil_pair_plain(q, wz_t, wplane, spec_a, spec_b)
    g3 = torch.cat([gram_plain(q, v), gram_plain(v, v), gram_plain(dst, q)])
    return dst.copy_(v), g3


def apply_stencil_pair_gram(
    q: torch.Tensor,
    dst: torch.Tensor,
    wz_t: torch.Tensor,
    wplane: torch.Tensor,
    spec_a: StencilSpec,
    spec_b: StencilSpec,
):
    """q, dst: (p, 6, Zc, P).  Returns (v, g3): v = A q written into dst's
    buffer (v is dst); g3 = [gram(q,v); gram(v,v); gram(dst_old,q)]
    (3p, p), gram(x,y)[k,j] = <x_k, y_j> over the whole state, accumulated
    in the state's type; on the card the same bits on every run.  dst's
    old contents are gone afterwards.  Either half may be paired or not;
    on the card it is one launch either way.  A geometry whose staged rows
    do not fit a block's shared memory raises ValueError before launch."""
    if q.ndim != 4 or q.shape != dst.shape:
        raise ValueError(
            f"q/dst must be (p,6,Zc,P), got {tuple(q.shape)}/{tuple(dst.shape)}"
        )
    if q.data_ptr() == dst.data_ptr():
        raise ValueError("q and dst must be different buffers")
    if q.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"apply_stencil_pair_gram takes float32 or float64 "
                         f"states, not {q.dtype} (no bfloat16, as in JAX)")
    if q.device.type == "cpu":
        return apply_stencil_pair_gram_plain(q, dst, wz_t, wplane, spec_a, spec_b)
    build.require_cuda("apply_stencil_pair_gram", q, dst, wz_t, wplane)
    p = q.shape[0]
    if not 1 <= p <= MAX_P:
        raise ValueError(f"CUDA stencil_gram takes 1 <= p <= {MAX_P}, got {p}")
    nt = check_geometry(q, wz_t, wplane, spec_a)
    if q.data_ptr() % 16:
        raise ValueError("apply_stencil_pair_gram: q must start on a 16-byte "
                         "boundary")
    plan = pair_gram_plan(spec_a, spec_b, p, q.element_size(),
                          build.sm_count(q.device))
    partial = torch.empty((plan.strips * plan.chunks, 3 * p, p), dtype=q.dtype,
                          device=q.device)
    g3 = torch.empty((3 * p, p), dtype=q.dtype, device=q.device)
    build.launch(
        "apply_stencil_pair_gram", q, "lt_stencil_pair_gram",
        build.dtype_code(q), q.data_ptr(), dst.data_ptr(), wz_t.data_ptr(),
        wplane.data_ptr(), tap_table(spec_a, spec_b), plan.ints,
        plan.columns, p, spec_a.zc, spec_a.plane, nt, partial.data_ptr(),
        _ticket(q).data_ptr(), g3.data_ptr(), build.stream_handle(q),
    )
    return dst, g3
