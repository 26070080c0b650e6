"""Top-k Ritz value/vector extraction, eigsh-style (port of
`lanczos_tpu/methods/eigs.py`).

Diagonalize the (block-)tridiagonal T of a Lanczos run and optionally lift
the Ritz vectors through the stored basis; |beta_m s_{m,i}| (its block
form ||beta_m S_{m,i}||) is the standard Lanczos residual bound, and
`ritz_residuals` measures the true residuals with one more product.
Neither eigsh takes a bf16 state (`smalleig.refuse_bf16`).
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.methods.block_lanczos import block_lanczos
from lanczos_tpu_torch.methods.vector_lanczos import vector_lanczos
from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.smalleig import refuse_bf16
from lanczos_tpu_torch.ops.tridiag import (
    assemble_block_tridiagonal,
    assemble_tridiagonal,
)
from lanczos_tpu_torch.utils import tracing


@tracing.spanned("lt.eigsh.residuals")
def ritz_residuals(a, vals: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """MEASURED relative Ritz residuals ||A y_i - theta_i y_i|| /
    (|theta_i| ||y_i||), with one block product of the k pairs.  The
    |beta_m S| bound can read arbitrarily small after deflation; this is
    the backward-error certificate to publish beside it.

    vals: (k,); vecs: (n, k) columns, n the operator's flattened state
    (an operator with a `state_shape` gets each column in that shape).
    Returns (k,).  Any k works: the port's padded states take any block
    width, so no rows are padded.  On an operator with a `mesh` vecs
    holds this rank's rows; the squared norms are summed over the ranks,
    so every rank returns the same global ratios."""
    k = vals.shape[0]
    ys = vecs.T.reshape((k,) + tuple(getattr(a, "state_shape", vecs.shape[:1])))
    ys = ys.contiguous()  # block-major (k, *state)
    r = (a.mm(ys) - vals.view((k,) + (1,) * (ys.ndim - 1)) * ys).reshape(k, -1)
    ys = ys.reshape(k, -1)
    tiny = torch.finfo(vecs.dtype).tiny
    mesh = getattr(a, "mesh", None)
    if mesh is None:
        r_norm, y_norm = torch.linalg.norm(r, dim=1), torch.linalg.norm(ys, dim=1)
    else:
        sq = mesh.all_reduce_(torch.stack([torch.sum(r * r, dim=1),
                                           torch.sum(ys * ys, dim=1)]))
        r_norm, y_norm = torch.sqrt(sq[0]), torch.sqrt(sq[1])
    return r_norm / (torch.abs(vals) * y_norm + tiny)


def _select(w: torch.Tensor, k: int, which: str) -> torch.Tensor:
    """Indices of the k wanted eigenvalues, in JAX's order (a reversed
    stable argsort for the largest)."""
    if which == "LA":
        return torch.argsort(w, stable=True).flip(0)[:k]
    if which == "SA":
        return torch.argsort(w, stable=True)[:k]
    if which == "LM":
        return torch.argsort(torch.abs(w), stable=True).flip(0)[:k]
    raise ValueError(f"unknown which={which!r}")


@tracing.spanned("lt.eigsh.vector")
def lanczos_eigsh(
    a,
    b: torch.Tensor,
    m: int,
    k: int,
    *,
    which: str = "LA",
    reorth: str = "full",
    compute_vectors: bool = False,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    fused: bool | None = None,
):
    """Top-k Ritz pairs from an m-step single-vector Lanczos run.

    Returns (values (k,), vectors (n, k) or None, residual bounds (k,))."""
    refuse_bf16(b, "lanczos_eigsh")
    res = vector_lanczos(a, b, m, reorth=reorth, store_basis=compute_vectors,
                         breakdown_tol=breakdown_tol, trace_fn=trace_fn,
                         fused=fused)
    with tracing.span("lt.eigsh.ritz"):
        t = assemble_tridiagonal(res.alphas, res.betas[1:])
        w, s = torch.linalg.eigh(t)
        idx = _select(w, k, which)
        vals = w[idx]
        # |beta_m s_{m,i}| with the TRUE beta_m = ||w_m|| (res.beta_final)
        resid = torch.abs(res.beta_final * s[-1, idx])
        vecs = None
        if compute_vectors:
            vecs = res.basis.reshape(m, -1).T @ s[:, idx]
    return vals, vecs, resid


@tracing.spanned("lt.eigsh.block")
def block_lanczos_eigsh(
    a,
    b: torch.Tensor,
    m: int,
    k: int,
    *,
    which: str = "LA",
    reorth: str = "full",
    compute_vectors: bool = False,
    eig_backend: str = "jacobi",
    normalize: str = "sqrtm",
    breakdown_eps: float = 0.0,
    breakdown_tol: float = 0.0,
    replace_dead: bool = False,
    fused: bool | None = None,
    compensated: bool = False,
):
    """Top-k Ritz pairs from an m-step block-Lanczos run.  b is BLOCK-MAJOR
    (p, n).  Returns (values (k,), vectors (n, k) or None, residual
    bounds (k,)).  The solver options forward to `block_lanczos`."""
    refuse_bf16(b, "block_lanczos_eigsh")
    res = block_lanczos(
        a, b, m, reorth=reorth, store_basis=compute_vectors,
        eig_backend=eig_backend, normalize=normalize,
        breakdown_eps=breakdown_eps, breakdown_tol=breakdown_tol,
        replace_dead=replace_dead, fused=fused, compensated=compensated,
    )
    p = b.shape[0]
    with tracing.span("lt.eigsh.ritz"):
        t = assemble_block_tridiagonal(res.alphas, res.betas[1:])
        w, s = torch.linalg.eigh(t)
        idx = _select(w, k, which)
        vals = w[idx]
        # ||beta_m S_{m-block, i}|| with the TRUE beta_m (res.beta_final)
        resid = torch.linalg.norm(res.beta_final @ s[-p:, idx], dim=0)
        vecs = None
        if compute_vectors:
            # basis (m, p, n) block-major; T's ordering is j*p + c
            vecs = res.basis.reshape(m * p, -1).T @ s[:, idx]
    return vals, vecs, resid
