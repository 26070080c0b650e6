"""Traffic-minimal ("fused") block Lanczos: the residual is never stored.

Port of `lanczos_tpu/methods/block_lanczos_fused.py`.  The materialized
recurrence spends ~15 passes over the block state per iteration across
six separate ops.  This path reorganizes the algebra so each iteration
runs three big-array passes:

  1. ``q_j   = block_mix(E, (q_{j-2}, q_{j-1}, v_{j-1}))``   (K2)
  2. ``v_j   = A @ q_j``                                     (K1)
  3. ``gram((q_j,), v_j, include_zz)``                       (K3)

where v = A q is the raw operator application and E a (3p, p) coefficient
matrix computed from p x p algebra only:

* the residual w_j = v_j - q_{j-1} beta_j^T - q_j alpha_j is a linear
  combination of (q_{j-1}, q_j, v_j), so its Gram — hence beta_{j+1} =
  sqrtm(w^T w) and the normalization inv — follow from the 3p x 3p Gram
  blocks M of that triple without materializing w;
* normalization composes into the same combination: q_{j+1} = w inv =
  block_mix([-beta^T inv; -alpha inv; inv], triple);
* by symmetry of A, gram(q_{j-1}, v_j) = gram(v_{j-1}, q_j), derivable
  from M and E.

For p >= 2 with an operator that has the fused stencil + Gram pass
(K4, `stencil_gram`), every step from j = 2 on is the two-call "mono"
step: block_mix writes q_j over q_{j-2}'s buffer in place, then K4 writes
v_j = A q_j over v_{j-1}'s buffer while it streams v_{j-1} for the m13
Gram block.  The Python loop rotates the buffer references
(u1, u2, u3) -> (u2, q_j, v_j); the JAX version's two-steps-per-scan-body
trick only worked around XLA's donation rules and is not needed here.

compensated=True takes every Gram from `block_grams_compensated` (K7,
f64 accumulation of f32 states: O(eps) instead of O(eps sqrt(n))) and runs
the 3-call step, as does store_basis=True, which keeps every q_j (the mono
step overwrites q_{j-2}'s buffer).

Semantics: identical to `block_lanczos(reorth='none', normalize='sqrtm')`
in exact arithmetic.  alpha, beta and the trace stay on the device: the
loop never waits for it.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.methods.block_lanczos import BlockLanczosResult, _fro, _sym
from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.kernels.block_dense import (
    acc_dtype,
    block_grams,
    block_grams_compensated,
    block_mix,
)
from lanczos_tpu_torch.ops.operator import state_trace
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm
from lanczos_tpu_torch.utils import tracing


def block_lanczos_fused(
    a,
    b: torch.Tensor,
    m: int,
    lc=None,
    *,
    store_basis: bool = False,
    eig_backend: str = "jacobi",
    breakdown_eps: float = 0.0,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    compensated: bool = False,
):
    """Drop-in for `block_lanczos(..., reorth='none', normalize='sqrtm')`.
    Returns the same `BlockLanczosResult` (with `basis` (m, p, *state)
    when store_basis).  See module docstring."""
    p = b.shape[0]
    dtype = b.dtype
    lc_idx = 0 if lc is None else int(lc)
    trace_at = trace_fn or (lambda q: state_trace(q, lc_idx, block=True))
    cdt = acc_dtype(dtype)
    tiny = torch.finfo(dtype).tiny
    grams = block_grams_compensated if compensated else block_grams

    def sqrtm_inv(g):
        g = g.to(dtype)
        if p == 1:
            # scalar block: sqrtm is sqrt, pinv a guarded reciprocal
            s_ = torch.sqrt(g.abs())
            ok = s_ > 0
            return s_, torch.where(ok, 1.0 / torch.where(ok, s_, 1.0), 0.0)
        return sqrtm_invsqrtm(g, backend=eig_backend,
                              breakdown_eps=breakdown_eps)

    def norm_coeffs(gwn, dead):
        """(beta, inv, dead') from the residual Gram; freezes to zeros once
        the reciprocal condition estimate crosses breakdown_tol."""
        beta, inv = sqrtm_inv(gwn)
        rcond = 1.0 / torch.clamp(_fro(inv) * _fro(beta), min=tiny)
        if breakdown_tol > 0.0:
            # an EXACTLY invariant subspace gives beta = inv = 0 (pinv),
            # which the product-of-norms estimate reads as healthy
            dead = dead | (rcond <= breakdown_tol) | (_fro(beta) <= tiny)
            beta = torch.where(dead, torch.zeros_like(beta), beta)
            inv = torch.where(dead, torch.zeros_like(inv), inv)
        return beta, inv, dead

    def gwn2(g_qv, g_vv, g_qq, s2):
        return g_vv - g_qv.T @ s2 - s2.T @ g_qv + s2.T @ (g_qq @ s2)

    # ---- prologue: q0, v0 = A q0, alpha0 -------------------------------
    with tracing.span("lt.lanczos.prologue"):
        gbb = grams((), b, include_zz=True)  # (p, p): one read of b
        beta0, inv0 = sqrtm_inv(gbb)
        q0 = block_mix(inv0.to(cdt), (b,))
        v0 = a.mm(q0)
        g2 = grams((q0,), v0, include_zz=True)  # [gram(q0,v0); gram(v0,v0)]
        g_qv, g_vv = g2[:p], g2[p:]
        g_qq = inv0.T.to(cdt) @ gbb @ inv0.to(cdt)
        alpha0 = _sym(g_qv.T).to(dtype)
        trace0 = trace_at(q0)
        dead = torch.zeros((), dtype=torch.bool, device=b.device)

    if m == 1:
        with tracing.span("lt.lanczos.coeffs"):
            beta_final, _ = sqrtm_inv(gwn2(g_qv, g_vv, g_qq, alpha0.to(cdt)))
        return BlockLanczosResult(
            alphas=alpha0[None], betas=beta0[None], trace=trace0[None],
            beta_final=beta_final, breakdown=dead,
            basis=q0[None] if store_basis else None,
        )

    # ---- peeled step j=1 (doublet U = (q0, v0)) ------------------------
    with tracing.span("lt.lanczos.step"):
        tracing.count("lanczos.steps")
        with tracing.span("lt.lanczos.coeffs"):
            s2 = alpha0.to(cdt)
            beta1, inv1, dead = norm_coeffs(gwn2(g_qv, g_vv, g_qq, s2), dead)
            inv1f = inv1.to(cdt)
            e1 = torch.cat([-(s2 @ inv1f), inv1f])  # (2p, p)
        q1 = block_mix(e1, (q0, v0))
        v1 = a.mm(q1)
        g2 = grams((q1,), v1, include_zz=True)
        m23, m33 = g2[:p], g2[p:]
        with tracing.span("lt.lanczos.coeffs"):
            # 2p x 2p gram of (q0, v0) for the derived blocks
            gU = torch.cat([torch.cat([g_qq, g_qv], 1), torch.cat([g_qv.T, g_vv], 1)])
            m12 = torch.cat([g_qq, g_qv], 1) @ e1  # gram(q0, q1)
            m22 = e1.T @ (gU @ e1)  # gram(q1, q1)
            m13 = torch.cat([g_qv.T, g_vv], 1) @ e1  # gram(q0, v1) = gram(v0, q1)
            m11 = g_qq
            alpha1 = _sym(m23.T - beta1.to(cdt) @ m12).to(dtype)
        trace1 = trace_at(q1)
        del v0  # not in the carry: frees one block state

    def gwn_from(M, s1, s2):
        m11, m12, m13, m22, m23, m33 = M
        t1 = m13.T @ s1
        t2 = m23.T @ s2
        return (
            m33 - t1 - t2 - t1.T - t2.T
            + s1.T @ (m11 @ s1)
            + s1.T @ (m12 @ s2)
            + s2.T @ (m12.T @ s1)
            + s2.T @ (m22 @ s2)
        )

    mono = (
        not store_basis
        and not compensated
        and p >= 2  # p=1 is fixed-cost-bound (JAX measurement, TPU)
        and hasattr(a, "stencil_gram")
        and a.supports_stencil_gram(p, dtype)
    )

    alphas, betas, traces = [alpha0, alpha1], [beta0, beta1.to(dtype)], [trace0, trace1]
    qs = [q0, q1] if store_basis else []  # holds no buffer otherwise
    u1, u2, u3 = q0, q1, v1
    M = (m11, m12, m13, m22, m23, m33)
    alpha_prev, beta_prev = alpha1, beta1
    for _ in range(m - 2):
        with tracing.span("lt.lanczos.step"):
            tracing.count("lanczos.steps")
            with tracing.span("lt.lanczos.coeffs"):
                m11, m12, m13, m22, m23, m33 = M
                s1 = beta_prev.T.to(cdt)
                s2 = alpha_prev.to(cdt)
                beta_j, inv_j, dead = norm_coeffs(gwn_from(M, s1, s2), dead)
                invf = inv_j.to(cdt)
                e = torch.cat([-(s1 @ invf), -(s2 @ invf), invf])  # (3p, p)
                e = torch.where(dead, torch.zeros_like(e), e)
                gu2U = torch.cat([m12.T, m22, m23], 1)  # (p, 3p)
            if mono:
                # q_j over u1's buffer, then v_j over u3's (K2 in place, K4)
                q_j = block_mix(e, (u1, u2, u3), inplace=True)
                v_j, g3 = a.stencil_gram(q_j, u3)
                m23n, m33n = g3[:p], g3[p : 2 * p]
                m13n = g3[2 * p :]  # gram(u3, q_j): measured, not derived
            else:
                q_j = block_mix(e, (u1, u2, u3))
                v_j = a.mm(q_j)
                g2 = grams((q_j,), v_j, include_zz=True)
                m23n, m33n = g2[:p], g2[p:]
                gu3U = torch.cat([m13.T, m23.T, m33], 1)
                m13n = gu3U @ e  # gram(u2, v_j) = gram(u3, q_j)  [A sym.]
            with tracing.span("lt.lanczos.coeffs"):
                m12n = gu2U @ e  # gram(u2, q_j)
                Mfull = torch.cat([
                    torch.cat([m11, m12, m13], 1),
                    torch.cat([m12.T, m22, m23], 1),
                    torch.cat([m13.T, m23.T, m33], 1),
                ])
                m22n = e.T @ (Mfull @ e)  # gram(q_j, q_j)
                alpha_j = _sym(m23n.T - beta_j.to(cdt) @ m12n).to(dtype)
            alphas.append(alpha_j)
            betas.append(beta_j.to(dtype))
            traces.append(trace_at(q_j))
            if store_basis:
                qs.append(q_j)
            u1, u2, u3 = u2, q_j, v_j
            M = (m22, m12n, m13n, m22n, m23n, m33n)
            alpha_prev, beta_prev = alpha_j, beta_j

    with tracing.span("lt.lanczos.coeffs"):
        gwn_f = gwn_from(M, beta_prev.T.to(cdt), alpha_prev.to(cdt))
        beta_final, _ = sqrtm_inv(gwn_f)
    beta_final = torch.where(dead, torch.zeros_like(beta_final), beta_final)
    return BlockLanczosResult(
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        trace=torch.stack(traces),
        beta_final=beta_final,
        breakdown=dead,
        basis=torch.stack(qs) if store_basis else None,
    )
