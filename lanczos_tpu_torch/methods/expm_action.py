"""Matrix-exponential action via Lanczos: u(T) = expm(T*A) b at a receiver.

Port of `lanczos_tpu/methods/expm_action.py`, the end-to-end pipeline of
the reference driver:
  vector: solution = beta_0 * dot(expm(T_end*T) e_1, q_trace)
          (test_lanczos.cu:102-113)
  block:  solution = q_trace^T (expm(T_end*T)[:, :p] @ sqrtm(B^T B))
          (test_lanczos.cu:270-287)
where T is the (block-)tridiagonal Lanczos matrix and q_trace holds the
receiver row of each Krylov block (the basis itself is never stored).

expm(T) takes `torch.linalg.eigh`, which has no bf16 (nor has JAX's, which
raises NotImplementedError on a bf16 T after the whole Lanczos run): both
actions refuse a bf16 state with a ValueError before any work.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.smalleig import expm_sym, refuse_bf16
from lanczos_tpu_torch.ops.tridiag import (
    assemble_block_tridiagonal,
    assemble_tridiagonal,
)


def lanczos_expm_action(
    a,
    b: torch.Tensor,
    m: int,
    t_end: float,
    lc: int,
    *,
    reorth: str = "none",
    breakdown_tol: float = 0.0,
    trace_fn=None,
    fused: bool | None = None,
) -> torch.Tensor:
    """Scalar approximation of [expm(t_end*A) b]_lc via m-step Lanczos, a
    0-d tensor on b's device.  For non-flat operator states pass trace_fn
    (see `vector_lanczos`); the keyword options forward to it."""
    refuse_bf16(b, "the expm action")
    res = vector_lanczos(a, b, m, lc, reorth=reorth,
                         breakdown_tol=breakdown_tol, trace_fn=trace_fn,
                         fused=fused)
    t = assemble_tridiagonal(res.alphas, res.betas[1:])
    e = expm_sym(t_end * t, backend="lax")
    return res.betas[0] * torch.sum(e[:, 0] * res.trace)


def block_lanczos_expm_action(
    a,
    b: torch.Tensor,
    m: int,
    t_end: float,
    lc: int,
    *,
    reorth: str = "none",
    eig_backend: str = "jacobi",
    breakdown_tol: float = 0.0,
    trace_fn=None,
    normalize: str = "sqrtm",
    breakdown_eps: float = 0.0,
    replace_dead: bool = False,
    fused: bool | None = None,
    compensated: bool = False,
) -> torch.Tensor:
    """Row lc (length p) of expm(t_end*A) B via m-step block Lanczos, on
    b's device.  B is BLOCK-MAJOR (p, *state); for non-flat operator states
    pass trace_fn.  The keyword options forward to `block_lanczos`."""
    refuse_bf16(b, "the expm action")
    res = block_lanczos(a, b, m, lc, reorth=reorth, eig_backend=eig_backend,
                        breakdown_tol=breakdown_tol, trace_fn=trace_fn,
                        normalize=normalize, breakdown_eps=breakdown_eps,
                        replace_dead=replace_dead, fused=fused,
                        compensated=compensated)
    p = b.shape[0]
    t = assemble_block_tridiagonal(res.alphas, res.betas[1:])
    e = expm_sym(t_end * t, backend="lax")
    f1 = e[:, :p] @ res.betas[0]  # expm(T) E_1 sqrtm(B^T B)
    return res.trace.reshape(-1) @ f1
