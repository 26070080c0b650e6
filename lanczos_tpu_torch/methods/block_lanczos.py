"""Block Lanczos tridiagonalization (port of `lanczos_tpu/methods/
block_lanczos.py`).

Same recurrence as the reference (`methods/block_lanczos.hpp:13-80`):
  beta_0^2 = B^T B;  Q_0 = B * invsqrtm(beta_0^2)
  W = A Q_0;  alpha_0 = sym(W^T Q_0);  W -= Q_0 alpha_0
  loop j = 1..m-1:
    beta_j = sqrtm(W^T W);  Q_1 = W * invsqrtm(W^T W)
    W = A Q_1 - Q_0 beta_j
    alpha_j = 0.5 (W^T Q_1 + Q_1^T W);  W -= Q_1 alpha_j

BLOCK-MAJOR convention: B has shape (p, *state_shape), the block axis
first.  `block_lanczos` dispatches exactly as the JAX package does: bare
(reorth="none", normalize="sqrtm") runs whose block state holds at least
16 MB, or fused=True, or compensated=True, go to the traffic-minimal
recurrence in `block_lanczos_fused.py`; the rest run the materialized
recurrence below.

Ported so far: reorth="none" with normalize="sqrtm" (plus breakdown_eps,
breakdown_tol, store_basis and, on the fused path, compensated Grams).
Re-orthogonalization, normalize="qr" and replace_dead are not: they raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.operator import state_trace
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm

FUSED_GATE_BYTES = 16 * 1024 * 1024  # JAX block_lanczos.py:170


@dataclasses.dataclass
class BlockLanczosResult:
    """alphas: (m, p, p); betas: (m, p, p) with betas[0] = sqrtm(B^T B) and
    betas[1:] the subdiagonal blocks; trace: (m, p) receiver value of each
    block column; beta_final: (p, p) symmetric factor sqrtm(W_m^T W_m) of
    the completed m-step residual block (the true beta_m); breakdown: 0-d
    bool, True if the recurrence was frozen at an invariant subspace
    (breakdown_tol > 0); basis: (m, p, *state) Krylov blocks with
    store_basis, else None.  All stay on the state's device."""

    alphas: torch.Tensor
    betas: torch.Tensor
    trace: torch.Tensor
    beta_final: torch.Tensor
    breakdown: torch.Tensor
    basis: torch.Tensor | None = None


def _sym(g):
    return 0.5 * (g + g.T)


def _gram(x, y):
    """x^T y over the state axes -> (p, q); x: (p, *state), y: (q, *state)."""
    return x.reshape(x.shape[0], -1) @ y.reshape(y.shape[0], -1).T


def _mix(s, x):
    """out[j] = sum_k s[k, j] x[k] (the reference's tall x small mm_ts)."""
    return (s.T @ x.reshape(x.shape[0], -1)).reshape(
        (s.shape[1],) + tuple(x.shape[1:])
    )


def _fro(x):
    return torch.sqrt(torch.sum(x * x))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to lanczos_tpu_torch yet (ROADMAP {item})"
    )


def block_lanczos(
    a,
    b: torch.Tensor,
    m: int,
    lc: int | None = None,
    *,
    reorth: str = "none",
    store_basis: bool = False,
    eig_backend: str = "jacobi",
    breakdown_eps: float = 0.0,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    normalize: str = "sqrtm",
    replace_dead: bool = False,
    fused: bool | None = None,
    compensated: bool = False,
) -> BlockLanczosResult:
    """b: (p, *state_shape), block-major.  `trace_fn(q) -> (p,)` overrides
    the default receiver extraction (flat index lc per block column).

    fused=None (auto) takes the fused recurrence when the block state holds
    >= 16 MB, as the JAX package does; fused=True forces it, fused=False
    forces the materialized one.  compensated=True takes every Gram from
    K7 (`block_grams_compensated`, f32 states only) and exists on the
    fused path only: it routes there, and fused=False contradicts it.
    breakdown_tol > 0 freezes the recurrence once sigma_min(beta_j) /
    ||beta_j||_F falls below it (frozen steps emit zero alpha/beta/trace
    rows; `breakdown` is set); breakdown_eps > 0 makes the inv-sqrtm a
    rank-revealing pseudo-inverse."""
    if reorth not in ("none", "full", "periodic", "selective"):
        raise ValueError(f"unknown reorth mode {reorth!r}")
    if normalize not in ("sqrtm", "qr"):
        raise ValueError(f"unknown normalize mode {normalize!r}")
    fusable = reorth == "none" and normalize == "sqrtm" and not replace_dead
    if compensated and not fusable:
        raise ValueError(
            "compensated=True is implemented on the fused path: requires "
            "reorth='none', normalize='sqrtm' and replace_dead=False"
        )
    if compensated and fused is False:
        raise ValueError(
            "compensated=True is only implemented on the fused path; "
            "fused=False contradicts it (drop one of the two)"
        )
    if reorth != "none":
        raise _not_ported(f"reorth={reorth!r}", "Queue 1 item 9")
    if normalize != "sqrtm":
        raise _not_ported("normalize='qr' (TSQR)", "Queue 1 item 9")
    if replace_dead:
        raise _not_ported("replace_dead (adaptive restart)", "Queue 1 item 9")
    big_enough = b.numel() * b.element_size() >= FUSED_GATE_BYTES
    if fused or compensated or (fused is None and big_enough):
        from lanczos_tpu_torch.methods.block_lanczos_fused import (
            block_lanczos_fused,
        )

        return block_lanczos_fused(
            a, b, m, lc,
            store_basis=store_basis,
            eig_backend=eig_backend,
            breakdown_eps=breakdown_eps,
            breakdown_tol=breakdown_tol,
            trace_fn=trace_fn,
            compensated=compensated,
        )

    p = b.shape[0]
    dtype = b.dtype
    lc_idx = 0 if lc is None else int(lc)
    trace_at = trace_fn or (lambda q: state_trace(q, lc_idx, block=True))
    tiny = torch.finfo(dtype).tiny

    def normalize_block(wv):
        """W = Q B: block-major Q, B = sqrtm(W^T W) and a scale-free
        reciprocal-condition estimate of B for the breakdown freeze."""
        beta, inv = sqrtm_invsqrtm(
            _gram(wv, wv), backend=eig_backend,
            breakdown_eps=breakdown_eps,
        )
        rcond = 1.0 / torch.clamp(_fro(inv) * _fro(beta), min=tiny)
        return _mix(inv, wv), beta, rcond

    # -- first half-iteration (a degenerate START block is the caller's
    # bug, not a breakdown: its rcond is not checked)
    q0, beta0, _ = normalize_block(b)
    w = a.mm(q0)
    alpha0 = _sym(_gram(w, q0))
    w = w - _mix(alpha0, q0)

    alphas, betas, traces = [alpha0], [beta0], [trace_at(q0)]
    qs = [q0] if store_basis else []  # holds no buffer otherwise
    dead = torch.zeros((), dtype=torch.bool, device=b.device)
    q_prev = q0
    for _ in range(1, m):
        q, beta, rcond = normalize_block(w)
        if breakdown_tol > 0.0:
            # freeze on (approximate) invariant subspace; an EXACTLY
            # invariant one gives beta = pinv = 0, caught by its norm
            dead = dead | (rcond <= breakdown_tol) | (_fro(beta) <= tiny)
            q = torch.where(dead, torch.zeros_like(q), q)
            beta = torch.where(dead, torch.zeros_like(beta), beta)
        # A V_j = V_{j-1} B_j^T + V_j A_j + V_{j+1} B_{j+1}
        wn = a.mm(q) - _mix(beta.T, q_prev)
        alpha = _sym(_gram(wn, q))
        w = wn - _mix(alpha, q)
        alphas.append(alpha)
        betas.append(beta)
        traces.append(trace_at(q))
        if store_basis:
            qs.append(q)
        q_prev = q

    # true beta_m of the completed factorization (only its norm enters the
    # Ritz bounds); a frozen run's residual is exactly zero
    beta_final, _ = sqrtm_invsqrtm(
        _gram(w, w), backend=eig_backend,
        breakdown_eps=breakdown_eps,
    )
    beta_final = torch.where(dead, torch.zeros_like(beta_final), beta_final)
    return BlockLanczosResult(
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        trace=torch.stack(traces),
        beta_final=beta_final,
        breakdown=dead,
        basis=torch.stack(qs) if store_basis else None,
    )
