"""S1: sqrtm and pinv-sqrtm of a batch of p x p symmetric Grams in one
launch.

The JAX package has no Pallas kernel here: its `jacobi_eigh` is jitted
(lanczos_tpu/ops/smalleig.py:44, with `sqrtm_invsqrtm` at :201), so XLA
runs the whole Jacobi solve inside the Lanczos `lax.scan` with no host
between its rounds.  Eager torch launches ~40 ops a rotation round from
the host, about 1,200 launches a call at p=4; the block recurrence calls
it m + 1 times a run.  On a CUDA tensor `jacobi_sqrtm` launches
jacobi_sqrtm_kernel of `csrc/lanczos_kernels.cu` once (one block a
matrix, the solve in shared memory); on a CPU tensor it runs
`jacobi_sqrtm_plain`, the op-by-op torch version, which the kernel
follows op for op (see the .cu's S1 section).

The launch is set by a pure function, `sqrtm_plan`: the padded size, one
thread an element in whole warps up to 1,024, and the shared-memory
bytes, which the .cu rechecks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lanczos_tpu_torch.ops.kernels import build

MAX_P = 64  # csrc kSqrtmMaxP: three f64 64 x 64 matrices in shared memory
MAX_THREADS = 1024  # csrc kSqrtmMaxThreads


class SqrtmPlan(NamedTuple):
    pp: int  # p padded to even (a decoupled unit row for odd p)
    threads: int
    smem: int  # shared-memory bytes


def sqrtm_plan(p: int, itemsize: int) -> SqrtmPlan:
    """S1's launch for p x p matrices of `itemsize` bytes: one thread an
    element of the padded pp x pp matrix, in whole warps, at most
    MAX_THREADS; shared memory for a, the next a and V (pp^2 each), J's
    diagonal and off-diagonal (pp each) and the pair partners (pp ints)."""
    if not 1 <= p <= MAX_P:
        raise ValueError(f"the CUDA Jacobi sqrtm takes 1 <= p <= {MAX_P}, got {p}")
    pp = p + p % 2
    threads = min(MAX_THREADS, -(-pp * pp // 32) * 32)
    return SqrtmPlan(pp, threads, (3 * pp * pp + 2 * pp) * itemsize + 4 * pp)


def lineup(i: int, r: int, pp: int) -> int:
    """Position i of round r's lineup, as the kernel computes it: the
    circle method of `ops.smalleig._round_robin_pairs` (0 fixed, 1..pp-1
    rotated right r times); pair k is (lineup(k), lineup(pp - 1 - k))."""
    return 0 if i == 0 else 1 + (i - 1 - r) % (pp - 1)


def sqrt_from_eigh(w: torch.Tensor, v: torch.Tensor, breakdown_eps: float):
    """(V diag(sqrt|w|) V^T, V diag(1/sqrt|w|) V^T): abs guards tiny
    negative rounding eigenvalues (reference my_sqrtm_cusolver.hpp:345-360);
    breakdown_eps > 0 makes the inverse a rank-revealing pseudo-inverse,
    eigenvalues under breakdown_eps * max|w| contributing zero."""
    wab = w.abs()
    s = torch.sqrt(wab)
    if breakdown_eps > 0.0:
        wmax = wab.amax(dim=-1, keepdim=True)
        good = wab > breakdown_eps * wmax
        s_inv = torch.where(good, 1.0 / torch.where(good, s, torch.ones_like(s)),
                            torch.zeros_like(s))
    else:
        s_inv = 1.0 / s
    vt = v.transpose(-1, -2)
    return (v * s[..., None, :]) @ vt, (v * s_inv[..., None, :]) @ vt


def jacobi_sqrtm_plain(a: torch.Tensor, sweeps: int = 10,
                       breakdown_eps: float = 0.0):
    """Plain torch version of `jacobi_sqrtm` (same contract): the
    op-by-op Jacobi of `ops.smalleig.jacobi_eigh`, then the epilogue."""
    from lanczos_tpu_torch.ops.smalleig import jacobi_eigh

    w, v = jacobi_eigh(a, sweeps=sweeps)
    return sqrt_from_eigh(w, v, breakdown_eps)


def jacobi_sqrtm(a: torch.Tensor, sweeps: int = 10, breakdown_eps: float = 0.0):
    """(sqrtm(A), pinv(sqrtm(A))) of symmetric a (..., p, p) by `sweeps`
    sweeps of parallel cyclic Jacobi: one launch for the whole batch on a
    CUDA tensor (f32, f64 or bf16, p <= MAX_P, else it raises), the plain
    version on a CPU tensor."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"jacobi_sqrtm takes (..., p, p), got {tuple(a.shape)}")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    if a.device.type == "cpu":
        return jacobi_sqrtm_plain(a, sweeps, breakdown_eps)
    p = a.shape[-1]
    plan = sqrtm_plan(p, a.element_size())
    flat = a.reshape(-1, p, p).contiguous()
    sq, inv = torch.empty_like(flat), torch.empty_like(flat)
    build.require_cuda("jacobi_sqrtm", flat, sq, inv, bf16=True)
    batch = flat.shape[0]
    if batch:
        build.launch(
            "jacobi_sqrtm", flat, "lt_sqrtm_invsqrtm",
            build.dtype_code(flat, True), flat.data_ptr(), sq.data_ptr(),
            inv.data_ptr(), batch, p, sweeps, ctypes.c_double(breakdown_eps),
            plan.threads, plan.smem, build.stream_handle(flat),
        )
    return sq.reshape(a.shape), inv.reshape(a.shape)
