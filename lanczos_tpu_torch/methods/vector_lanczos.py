"""Single-vector Lanczos tridiagonalization (port of `lanczos_tpu/methods/
vector_lanczos.py`, reference `methods/vector_lanczos.hpp:9-67`).

The three-term recurrence with alpha/beta kept on the device, plus:
  * `reorth="full"`: twice-iterated classical Gram-Schmidt (CGS2) of the
    residual against the stored basis every step;
  * `reorth="selective"`: Simon's omega-recurrence estimate of the loss of
    orthogonality; CGS2 only when max omega > sqrt(eps), and on the step
    after;
  * the breakdown guard: beta below `breakdown_tol * beta0` freezes the
    recurrence instead of dividing by ~0.

The JAX `lax.scan` is a Python loop.  The bare recurrence never waits for
the device.  `reorth="selective"` decides on the host whether a step
reorthogonalizes (the JAX `lax.cond`), which costs one device sync per
step.

Bare runs (reorth="none", breakdown_tol=0) whose state holds at least
16 MB, or fused=True, take the traffic-minimal fused recurrence at block
width 1 (`block_lanczos_fused.py`), as the JAX package does, unless the
operator is distributed (it has a `mesh`).  On such an operator every
norm, dot and CGS2 coefficient vector is summed over the ranks, the
selective branch is taken by all ranks or by none, and the trace is
summed once, at the end (see `block_lanczos.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from lanczos_tpu_torch.methods.block_lanczos import FUSED_GATE_BYTES, _local
from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.operator import state_trace


@dataclasses.dataclass
class VectorLanczosResult:
    """alphas: (m,); betas: (m,) with betas[0] = ||b|| and betas[1:] the
    subdiagonal of T; trace: (m,) basis value at the receiver per
    iteration; basis: (m, *state) Krylov basis if requested, else None;
    breakdown: 0-d bool, True if the recurrence was frozen at an
    (approximate) invariant subspace; beta_final: the true beta_m = ||w_m||
    of the completed m-step factorization (not betas[-1])."""

    alphas: torch.Tensor
    betas: torch.Tensor
    trace: torch.Tensor
    basis: torch.Tensor | None
    breakdown: torch.Tensor
    beta_final: torch.Tensor


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _cgs2(wv, basis, valid, total=_local):
    """w -= Q (Q^T w) twice, over the basis rows where valid is 1; `total`
    sums the coefficients over the ranks of a distributed state."""
    q = basis.reshape(basis.shape[0], -1)
    w = wv.reshape(-1)
    for _ in range(2):
        w = w - (valid * total(q @ w)) @ q
    return w.reshape(wv.shape)


def vector_lanczos(
    a,
    b: torch.Tensor,
    m: int,
    lc: int | None = None,
    *,
    reorth: str = "none",
    store_basis: bool = False,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    fused: bool | None = None,
) -> VectorLanczosResult:
    """b may have any state shape the operator takes (a flat (n,) vector,
    or the folded-plane (6, Zc, P) state).  `trace_fn(q) -> scalar`
    overrides the default receiver extraction (flat index lc).

    fused=None (auto) routes bare runs whose state holds >= 16 MB through
    the fused recurrence at block width 1; fused=True forces it (and needs
    a bare run); fused=False forces the classic recurrence."""
    if reorth not in ("none", "full", "selective"):
        raise ValueError(f"unknown reorth mode {reorth!r}")
    mesh = getattr(a, "mesh", None)
    big_enough = b.numel() * b.element_size() >= FUSED_GATE_BYTES
    fusable = reorth == "none" and breakdown_tol == 0.0 and mesh is None
    if fused and not fusable:
        raise ValueError(
            "fused=True requires reorth='none', breakdown_tol=0 and a "
            "non-distributed operator"
        )
    if fusable and (fused or (fused is None and big_enough)):
        from lanczos_tpu_torch.methods.block_lanczos_fused import (
            block_lanczos_fused,
        )

        btrace = None
        if trace_fn is not None:
            btrace = lambda q: trace_fn(q[0]).reshape(1)  # noqa: E731
        r = block_lanczos_fused(a, b[None], m, lc, store_basis=store_basis,
                                trace_fn=btrace)
        return VectorLanczosResult(
            alphas=r.alphas[:, 0, 0],
            betas=r.betas[:, 0, 0],
            trace=r.trace[:, 0],
            basis=r.basis[:, 0] if r.basis is not None else None,
            breakdown=r.breakdown,
            beta_final=r.beta_final[0, 0],
        )

    need_basis = store_basis or reorth in ("full", "selective")
    dtype, dev = b.dtype, b.device
    eps = torch.finfo(dtype).eps
    sqrt_eps = eps ** 0.5
    tiny = torch.finfo(dtype).tiny
    lc_idx = 0 if lc is None else int(lc)
    if trace_fn is not None:
        trace_at = trace_fn
    elif mesh is not None:
        trace_at = a.storage_trace_fn(lc_idx)
    else:
        trace_at = lambda q: state_trace(q, lc_idx, block=False)  # noqa: E731
    if mesh is None:
        total, decide, n = _local, bool, b.numel()
        norm = _norm
    else:
        total, decide, n = mesh.all_reduce_, mesh.any, b.numel() * mesh.size

        def norm(x):
            return torch.sqrt(total(torch.sum(x * x)))

    beta0 = norm(b)
    q0 = b / beta0
    w = a.mv(q0)
    alpha0 = total(torch.sum(w * q0))
    w = w - alpha0 * q0

    karr = torch.arange(m, device=dev)
    basis = None
    if need_basis:
        basis = torch.zeros((m,) + tuple(b.shape), dtype=dtype, device=dev)
        basis[0] = q0
    # histories indexed by k: alph_hist[k] = alpha_k, beta_hist[k] = beta_k
    # (beta_0 := ||b||); om = omega_{j-1,.}, om_prev = omega_{j-2,.}
    alph_hist = torch.zeros(m, dtype=dtype, device=dev)
    beta_hist = torch.zeros(m, dtype=dtype, device=dev)
    alph_hist[0], beta_hist[0] = alpha0, beta0
    om_prev = torch.zeros(m, dtype=dtype, device=dev)
    om = torch.zeros(m, dtype=dtype, device=dev)
    om[0] = 1.0
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    force = False

    alphas, betas, traces = [alpha0], [beta0], [trace_at(q0)]
    q_prev, wv = q0, w
    for j in range(1, m):
        if reorth == "selective":
            # omega_{j,k} ~ q_j . q_k by the three-term recurrence (Simon
            # '84), with beta_0 := 0 (no q_{-1}) and a rounding-noise floor
            # so that the estimate can seed and grow
            beta_tent = torch.clamp(norm(wv), min=tiny)
            bh = beta_hist.clone()
            bh[0] = 0.0
            b_kp1 = torch.roll(bh, -1)
            tilde = ((alph_hist - alph_hist[j - 1]) * om
                     + b_kp1 * torch.roll(om, -1)
                     + bh * torch.roll(om, 1)
                     - bh[j - 1] * om_prev)
            om_new = tilde / beta_tent + eps * (b_kp1 + beta_tent) / beta_tent
            seed = eps * n * bh[1] / beta_tent
            om_new = torch.where(karr == j - 1, seed, om_new)
            om_new = torch.where(karr == j, 1.0, om_new)
            om_new = torch.where(karr > j, 0.0, om_new)
            older = karr <= j - 2
            # the host decides (one sync per step): JAX's lax.cond
            trigger = force or decide(
                torch.abs(torch.where(older, om_new, 0.0)).max() > sqrt_eps
            )
            if trigger:
                wv = _cgs2(wv, basis, (karr <= j - 1).to(dtype), total)
                om_new = torch.where(karr <= j - 1, eps, om_new)
            # reorthogonalize the following step too (standard pairing)
            force = trigger and not force
            om_prev, om = om, om_new

        beta = norm(wv)
        dead = dead | (beta <= breakdown_tol * beta0)
        beta_safe = torch.where(dead, 1.0, beta)
        q = torch.where(dead, torch.zeros_like(wv), wv / beta_safe)
        beta_out = torch.where(dead, 0.0, beta)

        wn = a.mv(q) - beta_out * q_prev
        alpha = total(torch.sum(wn * q))
        wn = wn - alpha * q
        if need_basis:
            basis[j] = q
        if reorth == "full":
            wn = _cgs2(wn, basis, (karr <= j).to(dtype), total)

        alph_hist[j], beta_hist[j] = alpha, beta_out
        alphas.append(alpha)
        betas.append(beta_out)
        traces.append(trace_at(q))
        q_prev, wv = q, wn

    return VectorLanczosResult(
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        trace=total(torch.stack(traces)),
        basis=basis if store_basis else None,
        breakdown=dead,
        beta_final=torch.where(dead, 0.0, norm(wv)),
    )
