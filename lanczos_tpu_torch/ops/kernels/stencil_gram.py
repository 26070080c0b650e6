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
is not ported: `supports` only asks for what the kernel takes.

The kernel takes paired halves.  With an unpaired half the wrapper
composes hand kernels, as the Pallas kernel's unpaired branch computes
the same product: gram(dst, q) by K3 first, then A q written into dst by
two K6 launches (one a half), then [gram(q, v); gram(v, v)] by K3.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.block_dense import block_grams, gram_plain
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    StencilSpec,
    apply_stencil_pair_plain,
    check_geometry,
    stencil_into,
    tap_table,
)

MAX_P = 8  # csrc stencil_gram_kernel instantiations (registers: 3 p^2 sums)


def supports(p: int, dtype: torch.dtype) -> bool:
    """Whether the fused pass takes p block columns of this dtype: f32
    (as the Pallas kernel) and p <= MAX_P (the kernel keeps 3 p^2 Gram
    sums per thread in registers)."""
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
    in the state's type.  dst's old contents are gone afterwards.  Either
    half may be paired or not; on the card an unpaired half runs K3 and K6
    instead of K4 (`_unpaired_gram`)."""
    if q.ndim != 4 or q.shape != dst.shape:
        raise ValueError(
            f"q/dst must be (p,6,Zc,P), got {tuple(q.shape)}/{tuple(dst.shape)}"
        )
    if q.data_ptr() == dst.data_ptr():
        raise ValueError("q and dst must be different buffers")
    if q.device.type == "cpu":
        return apply_stencil_pair_gram_plain(q, dst, wz_t, wplane, spec_a, spec_b)
    build.require_cuda("apply_stencil_pair_gram", q, dst, wz_t, wplane)
    p = q.shape[0]
    if not 1 <= p <= MAX_P:
        raise ValueError(f"CUDA stencil_gram takes 1 <= p <= {MAX_P}, got {p}")
    nt = check_geometry(q, wz_t, wplane, spec_a)
    if not (spec_a.paired and spec_b.paired):
        return _unpaired_gram(q, dst, wz_t, wplane, spec_a, spec_b)
    taps = tap_table(spec_a, spec_b)
    state = 6 * spec_a.zc * spec_a.plane
    nblocks = build.grid_blocks(state)
    partial = torch.empty((nblocks, 3 * p, p), dtype=q.dtype, device=q.device)
    g3 = torch.empty((3 * p, p), dtype=q.dtype, device=q.device)
    build.launch(
        "apply_stencil_pair_gram", q, "lt_stencil_pair_gram",
        build.dtype_code(q), q.data_ptr(), dst.data_ptr(), wz_t.data_ptr(),
        wplane.data_ptr(), taps, p, spec_a.zc, spec_a.plane, nt,
        partial.data_ptr(), nblocks, g3.data_ptr(), build.stream_handle(q),
    )
    return dst, g3


def _unpaired_gram(q, dst, wz_t, wplane, spec_a, spec_b):
    """K4's result from hand kernels when a half is unpaired: gram(dst, q)
    (K3) before dst is overwritten, A q into dst (K6, a launch a half; a
    paired half sums its taps unfactored, which differs from the factored
    form in rounding only), then [gram(q, v); gram(v, v)] (K3)."""
    g_dq = block_grams((dst,), q)
    for h, spec in enumerate((spec_a, spec_b)):
        base = 3 * (1 - h)
        stencil_into(q[:, base : base + 3], dst[:, 3 * h : 3 * h + 3],
                     wz_t[h].T, wplane[h], spec)
    return dst, torch.cat([block_grams((q,), dst, include_zz=True), g_dq])
