"""Small symmetric eigenproblems: sqrtm / inv-sqrtm of the p x p Grams.

Port of `lanczos_tpu/ops/smalleig.py`.  The block recurrence needs sqrtm
and inv-sqrtm of a p x p SPD Gram every iteration (reference
`source/kernels/my_sqrtm_cusolver.hpp`).  Backends:

* "jacobi": parallel-ordered cyclic Jacobi with a fixed sweep count, all
  p x p matmuls and no data-dependent control flow, so it never waits on
  the device;
* "newton": coupled Newton-Schulz for sqrtm and inv-sqrtm together;
* "lax": `torch.linalg.eigh` (the JAX package's `jnp.linalg.eigh`),
  which takes no bf16 matrix in either package: JAX raises
  NotImplementedError, the port ValueError.  So `expm_sym`, which takes
  it, refuses a bf16 T, and the expm actions and eigsh refuse a bf16 state
  (`refuse_bf16`); the Jacobi and Newton backends run in bf16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)


def _round_robin_pairs(p: int) -> np.ndarray:
    """Round-robin tournament schedule: (p-1) rounds of p/2 disjoint pairs.

    Standard circle method: fix 0, rotate 1..p-1.  Requires even p.
    """
    assert p % 2 == 0
    rounds = []
    others = list(range(1, p))
    for _ in range(p - 1):
        lineup = [0] + others
        pairs = [(lineup[i], lineup[p - 1 - i]) for i in range(p // 2)]
        rounds.append(pairs)
        others = others[-1:] + others[:-1]
    return np.asarray(rounds, dtype=np.int64)  # (p-1, p/2, 2)


@functools.lru_cache(maxsize=None)
def _schedule(p: int, device: torch.device) -> torch.Tensor:
    """The round-robin schedule on the device, made once per (p, device):
    a blocking host-to-device copy in every call would stall the host
    until the device had drained its queue."""
    return torch.as_tensor(_round_robin_pairs(p), device=device)


def _sym(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + x.transpose(-1, -2))


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition of a symmetric matrix by parallel cyclic Jacobi.

    Returns (w, v) with a ~= v @ diag(w) @ v.T; supports leading batch
    dimensions.  Eigenvalues come in the sweep's order, not sorted.  The
    JAX version clamps tau for the TPU's emulated f64, whose range is
    f32's; IEEE f32/f64 arithmetic gives t -> 0 for huge tau on its own,
    so the clamp is dropped.
    """
    batch_shape = a.shape[:-2]
    p = a.shape[-1]
    a = a.reshape((-1, p, p))
    podd = p % 2 == 1
    pp = p + 1 if podd else p
    if podd:
        a = F.pad(a, (0, 1, 0, 1))
        # decouple the pad row: unit diagonal, zero off-diagonal
        a[:, p, p] = 1.0
    sched = _schedule(pp, a.device)
    eye = torch.eye(pp, dtype=a.dtype, device=a.device)
    bsz = a.shape[0]
    v = eye.expand(bsz, pp, pp).clone()
    for _ in range(sweeps):
        for pairs in sched:
            ii, jj = pairs[:, 0], pairs[:, 1]
            app = a[:, ii, ii]
            aqq = a[:, jj, jj]
            apq = a[:, ii, jj]
            # inner rotation (|theta| <= pi/4), Golub & Van Loan sym.schur2;
            # the apq == 0 guard keeps odd-size pad rows decoupled
            nz = apq != 0.0
            tau = (aqq - app) / torch.where(nz, 2.0 * apq, torch.ones_like(apq))
            sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(a.dtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            j = eye.expand(bsz, pp, pp).clone()
            j[:, ii, ii] = c
            j[:, jj, jj] = c
            j[:, ii, jj] = s
            j[:, jj, ii] = -s
            # re-symmetrize to kill rounding drift
            a = _sym(j.transpose(-1, -2) @ a @ j)
            v = v @ j
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    if podd:
        w = w[:, :p]
        v = v[:, :p, :p]
    return w.reshape(batch_shape + (p,)), v.reshape(batch_shape + (p, p))


def eigh(a: torch.Tensor, backend: str = "jacobi", sweeps: int = 10):
    """Symmetric eigendecomposition with selectable backend."""
    if backend == "jacobi":
        return jacobi_eigh(a, sweeps=sweeps)
    if backend == "lax":
        if a.dtype == torch.bfloat16:
            raise ValueError("eigh backend 'lax' takes no bfloat16 matrix "
                             "(nor does jnp.linalg.eigh)")
        return torch.linalg.eigh(a)
    raise ValueError(f"unknown eigh backend {backend!r}")


def refuse_bf16(b: torch.Tensor, what: str) -> None:
    """`what` (an expm action, an eigsh) ends in `eigh(T, "lax")`, which
    takes no bf16 T: refuse a bf16 state b before any work (JAX fails in
    eigh after its Lanczos run)."""
    if b.dtype == torch.bfloat16:
        raise ValueError(f"{what} takes no bfloat16 state: it ends in eigh, "
                         "which has no bfloat16 (as in JAX)")


def newton_sqrtm_invsqrtm(a: torch.Tensor, iters: int = 18):
    """(sqrtm(A), inv-sqrtm(A)) of an SPD matrix by the coupled
    Newton-Schulz iteration: Y_{k+1} = Y_k (3I - Z_k Y_k)/2,
    Z_{k+1} = (3I - Z_k Y_k)/2 Z_k with Y_0 = A/c, Z_0 = I, then un-scale
    by sqrt(c).  c = ||A||_F puts the spectrum in (0, 1]; a relative
    Tikhonov floor 16*eps*||A||_F*I keeps a singular Gram finite.  NOT
    rank-revealing: breakdown handling must use an eigh backend."""
    p = a.shape[-1]
    batch_shape = a.shape[:-2]
    a = a.reshape((-1, p, p))
    eps = torch.finfo(a.dtype).eps
    c = torch.sqrt((a * a).sum(dim=(-2, -1), keepdim=True))
    c = torch.clamp(c, min=torch.finfo(a.dtype).tiny)
    eye = torch.eye(p, dtype=a.dtype, device=a.device).expand(a.shape)
    a = a + (16.0 * eps * c) * eye
    y, z = a / c, eye
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * (z @ y)
        # re-symmetrize: Y, Z are symmetric in exact arithmetic
        y = _sym(y @ t)
        z = _sym(t @ z)
    rc = torch.sqrt(c)
    out_shape = batch_shape + (p, p)
    return (y * rc).reshape(out_shape), (z / rc).reshape(out_shape)


def sqrtm_invsqrtm(
    a: torch.Tensor,
    backend: str = "jacobi",
    sweeps: int | None = None,
    breakdown_eps: float = 0.0,
):
    """(sqrtm(A), pinv(sqrtm(A))) of an SPD (Gram) matrix.

    Eigendecompose and take sqrt(|lambda|) (the abs guards tiny negative
    rounding eigenvalues, reference my_sqrtm_cusolver.hpp:345-360).
    breakdown_eps > 0 makes the inverse a rank-revealing pseudo-inverse:
    eigenvalues below breakdown_eps * max(lambda) contribute zero.
    backend="newton" uses Newton-Schulz (`sweeps` = its iteration count)
    and requires breakdown_eps == 0.  sweeps=None picks the backend
    default (jacobi 10, newton 18).
    """
    if backend == "newton":
        if breakdown_eps > 0.0:
            raise ValueError(
                "backend='newton' cannot build the rank-revealing "
                "pseudo-inverse breakdown handling needs; use "
                "backend='jacobi' or 'lax' with breakdown_eps > 0"
            )
        return newton_sqrtm_invsqrtm(a, iters=18 if sweeps is None else sweeps)
    w, v = eigh(a, backend=backend, sweeps=10 if sweeps is None else sweeps)
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


def expm_sym(t: torch.Tensor, backend: str = "lax", sweeps: int = 16):
    """expm of a symmetric matrix via eigendecomposition, U exp(L) U^T —
    the reference's `expm_cusolver` (lib_utils.hpp:542)."""
    w, v = eigh(t, backend=backend, sweeps=sweeps)
    return (v * torch.exp(w)[..., None, :]) @ v.transpose(-1, -2)
