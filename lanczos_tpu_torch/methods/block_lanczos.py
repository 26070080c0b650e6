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
recurrence below, with everything the JAX one has: full, periodic and
selective (block-omega) re-orthogonalization against the stored basis,
normalize="qr" (TSQR) with its rank guard, and replace_dead (adaptive
restart of collapsed directions).

The JAX `lax.scan` is a Python loop, and each `lax.cond` on a value the
device computed (the full-reorth cleanup gate at breakdown_eps=0, the
selective trigger, replace_dead's dead-direction test) is a Python `if`
after one host read.  replace_dead's noise comes from a `torch.Generator`
seeded with restart_seed: JAX's PRNG stream is not reproduced, so that
mode matches JAX in its invariants, not in its numbers.

An operator with a `mesh` (`parallel.DistributedPallasMaxwell`) holds this
rank's slab of every state, and GSPMD's inserted psums become explicit
sums over the ranks: each Gram, state norm and CGS2 coefficient block is
one local product and one `all_reduce` of a p x p (or scalar) tensor,
normalize="qr" runs `tsqr_sharded`, every host branch on a device value
is taken by all ranks or by none (`Mesh.any`), and the stacked trace is
summed over the ranks once, at the end.  Such an operator never takes the
fused recurrence (JAX has no sharded K4).  On one device none of this
runs.
"""

from __future__ import annotations

import dataclasses

import torch

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.operator import state_trace
from lanczos_tpu_torch.ops.smalleig import sqrtm_invsqrtm
from lanczos_tpu_torch.ops.tsqr import tsqr, tsqr_sharded

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


def _local(t):
    return t


def _cgs2(wv, basis, total=_local):
    """W -= Q (Q^T W) over the given basis blocks (k, p, *state), twice;
    `total` sums the coefficients over the ranks of a distributed state."""
    if basis.shape[0] == 0:
        return wv
    qf = basis.reshape(-1, basis[0, 0].numel())
    w = wv.reshape(wv.shape[0], -1)
    for _ in range(2):
        w = w - total(qf @ w.T).T @ qf
    return w.reshape(wv.shape)


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
    restart_seed: int = 17,
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

    reorth: "none", "full" (CGS2 of the residual against the stored basis
    every step, plus the q-side cleanup when the normalization is
    ill-conditioned), "periodic" (cleanup and residual pass every other
    step) or "selective" (when the block-omega estimate of the basis
    overlap crosses sqrt(eps)).  normalize: "sqrtm" (the reference's
    symmetric beta_j = sqrtm(W^T W)) or "qr" (TSQR, upper-triangular
    beta_j).  breakdown_tol > 0 freezes the recurrence once sigma_min(beta_j)
    / ||beta_j||_F falls below it (frozen steps emit zero alpha/beta/trace
    rows; `breakdown` is set); breakdown_eps > 0 makes the inv-sqrtm a
    rank-revealing pseudo-inverse, or on the qr path zeroes the directions
    whose R diagonal collapsed.  replace_dead=True (needs normalize="qr",
    breakdown_eps > 0 and a basis-keeping reorth) refills those directions
    with fresh random vectors orthogonalized against the basis, with their
    beta rows zeroed."""
    if reorth not in ("none", "full", "periodic", "selective"):
        raise ValueError(f"unknown reorth mode {reorth!r}")
    if normalize not in ("sqrtm", "qr"):
        raise ValueError(f"unknown normalize mode {normalize!r}")
    mesh = getattr(a, "mesh", None)
    fusable = (reorth == "none" and normalize == "sqrtm" and not replace_dead
               and mesh is None)
    big_enough = b.numel() * b.element_size() >= FUSED_GATE_BYTES
    if fused and not fusable:
        raise ValueError(
            "fused=True requires reorth='none', normalize='sqrtm', "
            "replace_dead=False and a non-distributed operator"
        )
    if compensated and not fusable:
        raise ValueError(
            "compensated=True is implemented on the fused path: requires "
            "reorth='none', normalize='sqrtm', replace_dead=False and a "
            "non-distributed operator"
        )
    if compensated and fused is False:
        raise ValueError(
            "compensated=True is only implemented on the fused path; "
            "fused=False contradicts it (drop one of the two)"
        )
    if fusable and (fused or compensated or (fused is None and big_enough)):
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
    if replace_dead and (
        normalize != "qr" or breakdown_eps <= 0.0 or reorth == "none"
    ):
        raise ValueError(
            "replace_dead=True requires normalize='qr', breakdown_eps > 0 "
            "and a basis-keeping reorth mode (full/periodic/selective)"
        )

    need_basis = store_basis or reorth != "none"
    p = b.shape[0]
    dtype, dev = b.dtype, b.device
    lc_idx = 0 if lc is None else int(lc)
    if trace_fn is not None:
        trace_at = trace_fn
    elif mesh is not None:
        trace_at = a.storage_trace_fn(lc_idx)
    else:
        trace_at = lambda q: state_trace(q, lc_idx, block=True)  # noqa: E731
    if mesh is None:
        total, decide, n_state, cgs2 = _local, bool, b.numel(), _cgs2
    else:
        total, decide, n_state = mesh.all_reduce_, mesh.any, b.numel() * mesh.size

        def cgs2(wv, basis):
            return _cgs2(wv, basis, total)

    def gram(x, y):
        return total(_gram(x, y))

    def state_fro(x):
        return torch.sqrt(total(torch.sum(x * x)))

    def qr_rows(x):
        """(q, r) of the block-major x: q (p, n) orthonormal rows."""
        if mesh is not None:
            return tsqr_sharded(x.reshape(p, -1), mesh)
        qf, r = tsqr(x.reshape(p, -1).T)
        return qf.T, r

    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps
    sqrt_eps = eps ** 0.5
    eye = torch.eye(p, dtype=dtype, device=dev)

    def normalize_block(wv):
        """W = Q B (tall convention): block-major Q, B, and a scale-free
        reciprocal-condition estimate of B for the breakdown freeze:
        sigma_min(B)/||B||_F with sigma_min bounded below by 1/||R^-1||_F
        (qr) or 1/||inv||_F (sqrtm)."""
        if normalize == "qr":
            qt, r = qr_rows(wv)
            if breakdown_eps > 0.0:
                # rank guard: zero the Q columns (and R rows) whose R
                # diagonal has collapsed instead of keeping arbitrary
                # directions from a singular R
                d = torch.abs(torch.diagonal(r))
                keep = (d > breakdown_eps * d.max()).to(dtype)
                qt = qt * keep[:, None]
                r = r * keep[:, None]
            rsafe = r + torch.diag(torch.where(
                torch.abs(torch.diagonal(r)) <= tiny, tiny, 0.0).to(dtype))
            inv_r = torch.linalg.solve_triangular(rsafe, eye, upper=True)
            rcond = 1.0 / torch.clamp(_fro(inv_r) * _fro(r), min=tiny)
            return qt.reshape(wv.shape).contiguous(), r, rcond
        beta, inv = sqrtm_invsqrtm(
            gram(wv, wv), backend=eig_backend,
            breakdown_eps=breakdown_eps,
        )
        rcond = 1.0 / torch.clamp(_fro(inv) * _fro(beta), min=tiny)
        return _mix(inv, wv), beta, rcond

    # -- first half-iteration (a degenerate START block is the caller's
    # bug, not a breakdown: its rcond is not checked)
    q0, beta0, _ = normalize_block(b)
    w = a.mm(q0)
    alpha0 = _sym(gram(w, q0))
    w = w - _mix(alpha0, q0)

    basis = None
    if need_basis:
        basis = torch.zeros((m,) + tuple(b.shape), dtype=dtype, device=dev)
        basis[0] = q0
    # block-omega histories (selective): Frobenius norms of the alpha/beta
    # blocks stand in for the scalar |alpha|/|beta| of Simon's recurrence
    karr = torch.arange(m, device=dev)
    na_hist = torch.zeros(m, dtype=dtype, device=dev)
    nb_hist = torch.zeros(m, dtype=dtype, device=dev)
    na_hist[0], nb_hist[0] = _fro(alpha0), _fro(beta0)
    om_prev = torch.zeros(m, dtype=dtype, device=dev)
    om = torch.zeros(m, dtype=dtype, device=dev)
    om[0] = 1.0
    force = False
    noise = None
    if replace_dead:
        # each rank draws its own slab's noise
        noise = torch.Generator(device=dev).manual_seed(
            restart_seed + (0 if mesh is None else mesh.rank))

    alphas, betas, traces = [alpha0], [beta0], [trace_at(q0)]
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    q_prev = q0
    for j in range(1, m):
        trigger = False
        if reorth == "selective":
            # block omega recurrence (Simon '84 with block Frobenius
            # norms): estimate max_k ||Q_j^T Q_k|| and clean up only when
            # it crosses sqrt(eps)
            nb_tent = torch.clamp(state_fro(w), min=tiny)
            nbh = nb_hist.clone()
            nbh[0] = 0.0
            nb_kp1 = torch.roll(nbh, -1)
            tilde = ((na_hist + na_hist[j - 1]) * om
                     + nb_kp1 * torch.roll(om, -1)
                     + nbh * torch.roll(om, 1)
                     + nbh[j - 1] * om_prev)
            om_new = tilde / nb_tent + eps * (nb_kp1 + nb_tent) / nb_tent
            seed = eps * n_state * nbh[1] / nb_tent
            om_new = torch.where(karr == j - 1, seed, om_new)
            om_new = torch.where(karr == j, 1.0, om_new)
            om_new = torch.where(karr > j, 0.0, om_new)
            older = karr <= j - 2
            # the host decides (one sync per step): JAX's lax.cond
            trigger = force or decide(
                torch.abs(torch.where(older, om_new, 0.0)).max() > sqrt_eps)
            if trigger:
                om_new = torch.where(karr <= j - 1, eps, om_new)
            force = trigger and not force
            om_prev, om = om, om_new

        q, beta, rcond = normalize_block(w)

        # q-side cleanup after normalization: normalization amplifies the
        # residual's eps-level basis components by 1/sigma_i in each
        # nearly dead direction, so q itself is cleaned (CGS2 against the
        # basis, a within-block re-QR whose R folds into beta)
        if reorth == "full":
            # with no near-dead handling asked for, clean only when the
            # normalization was ill-conditioned (one host read)
            do_clean = (breakdown_eps > 0.0 or replace_dead
                        or decide(rcond <= sqrt_eps))
        elif reorth == "periodic":
            do_clean = j % 2 == 0
        else:
            do_clean = trigger
        if reorth != "none":
            if breakdown_eps > 0.0:
                d0 = torch.abs(torch.diagonal(beta))
                keep = (d0 > breakdown_eps * d0.max()).to(dtype)
            else:
                keep = torch.ones(p, dtype=dtype, device=dev)
            if replace_dead:
                do_clean = do_clean or decide((keep < 1.0).any())
            if do_clean:
                kshape = (p,) + (1,) * (q.ndim - 1)
                if replace_dead:
                    # adaptive restart: refill collapsed directions with
                    # noise; CGS2 + re-QR make them fresh basis-orthogonal
                    # unit directions, the zeroed beta rows decouple them
                    q = q + torch.randn(q.shape, generator=noise, dtype=dtype,
                                        device=dev) * (1.0 - keep).view(kshape)
                q = cgs2(q, basis[:j])
                qt, r2 = qr_rows(q)
                q = qt.reshape(q.shape).contiguous()
                beta = r2 @ beta
                if not replace_dead:
                    # deflation: the re-QR refills exactly-zero directions
                    # with arbitrary completions; re-zero them
                    q = q * keep.view(kshape)
                beta = beta * keep[:, None]
        if breakdown_tol > 0.0:
            # freeze on (approximate) invariant subspace; an EXACTLY
            # invariant one gives beta = pinv = 0, caught by its norm
            dead = dead | (rcond <= breakdown_tol) | (_fro(beta) <= tiny)
            q = torch.where(dead, torch.zeros_like(q), q)
            beta = torch.where(dead, torch.zeros_like(beta), beta)
        # A V_j = V_{j-1} B_j^T + V_j A_j + V_{j+1} B_{j+1}: subtract the
        # TRANSPOSED subdiagonal block (beta for sqrtm; needed for qr)
        wn = a.mm(q) - _mix(beta.T, q_prev)
        alpha = _sym(gram(wn, q))
        w = wn - _mix(alpha, q)
        if need_basis:
            basis[j] = q
        # residual-side pass: every step for full; for periodic and
        # selective whenever the cleanup fired, which removes the A V =
        # V T + E inconsistency the q-side cleanup alone leaves
        if reorth == "full" or (reorth != "none" and do_clean):
            w = cgs2(w, basis[: j + 1])

        na_hist[j], nb_hist[j] = _fro(alpha), _fro(beta)
        alphas.append(alpha)
        betas.append(beta)
        traces.append(trace_at(q))
        q_prev = q

    # true beta_m of the completed factorization (only its norm enters the
    # Ritz bounds): the qr path takes TSQR's R, never forming the Gram; a
    # frozen run's residual is exactly zero
    if normalize == "qr":
        _, beta_final = qr_rows(w)
    else:
        beta_final, _ = sqrtm_invsqrtm(
            gram(w, w), backend=eig_backend,
            breakdown_eps=breakdown_eps,
        )
    beta_final = torch.where(dead, torch.zeros_like(beta_final), beta_final)
    return BlockLanczosResult(
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        trace=total(torch.stack(traces)),
        beta_final=beta_final,
        breakdown=dead,
        basis=basis if store_basis else None,
    )
