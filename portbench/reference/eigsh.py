"""Plain reference of the `eigsh` driver: m-step block Lanczos with QR
normalization and full re-orthogonalization (classical Gram-Schmidt, two
passes, against every stored block), the top-k Ritz pairs of its block
tridiagonal T, and measured residuals ||A y - theta y|| / (|theta| ||y||),
on the reference's own matrix (`reference/banded.py`) from the same
diagonals and start blocks the program was given.

A request's Ritz values are held to one run of the reference from the
same start block; the Ritz vectors the driver kept (the first request of
each start block) are measured against the matrix.  Imports nothing of
the program.
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.reference.arith import Arith
from portbench.reference.banded import Banded
from portbench.reference.expm import block_tridiagonal, sym


def ritz(op, b: torch.Tensor, m: int, k: int, ar: Arith, vectors: bool):
    """(values (k,), vectors (k, n) or None) of the k largest Ritz values."""
    p, n = b.shape
    basis = torch.empty((m, p, n), dtype=ar.dtype, device=b.device)

    def cgs2(w, upto):
        qf = basis[:upto].reshape(upto * p, n)
        for _ in range(2):
            w = w - ar.mm(ar.mm(w, qf.T), qf)
        return w

    q, _ = torch.linalg.qr(b.to(ar.dtype).T)
    basis[0] = q.T
    w = op.mm(basis[0])
    alpha = sym(ar.mm(w, basis[0].T))
    w = cgs2(w - ar.mm(alpha, basis[0]), 1)
    alphas, betas = [alpha], []
    for j in range(1, m):
        q, r = torch.linalg.qr(w.T)
        basis[j] = q.T
        w = op.mm(basis[j]) - ar.mm(r, basis[j - 1])
        alpha = sym(ar.mm(w, basis[j].T))
        w = cgs2(w - ar.mm(alpha, basis[j]), j + 1)
        alphas.append(alpha)
        betas.append(r)
    del w
    vals, s = torch.linalg.eigh(block_tridiagonal(alphas, betas))
    idx = torch.argsort(vals, descending=True)[:k]
    vecs = ar.mm(s[:, idx].T, basis.reshape(m * p, n)) if vectors else None
    return vals[idx], vecs


def residuals(op, vals: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """||A y_i - theta_i y_i|| / (|theta_i| ||y_i||) in op's arithmetic."""
    ar = op.ar
    y = vecs.to(ar.dtype)
    th = vals.to(ar.dtype)[:, None]
    return ar.norm(op.mm(y) - ar.mul(th, y), dim=1) / (th[:, 0].abs() * ar.norm(y, dim=1))


def _matrix(cfg, seed, device, ar):
    upper, diag = inputs.banded_diagonals(cfg, int(cfg["rows"]), seed, device)
    return Banded(upper, diag, ar)


def judge(cfg, tr, seed, device, records, kept) -> dict:
    """ritz_rel_err: the largest |theta - theta_ref| / |theta_ref| of any
    request; residual_max: the largest measured residual of a kept Ritz
    pair; residual_gap: the largest gap between a kept pair's residual as
    the program reported it and as measured here.
    kept: {blk: (vals (k,), vecs (k, n), reported residuals (k,))}."""
    ar = Arith("f64")
    op = _matrix(cfg, seed, device, ar)
    worst = {"ritz_rel_err": 0.0, "residual_max": 0.0, "residual_gap": 0.0}

    def note(name, x):
        worst[name] = max(worst[name], x) if x == x else float("inf")

    for blk in sorted({r["blk"] for r in records} | set(kept)):
        b = inputs.banded_block(op.n, tr["p"], seed, blk, device)
        want, _ = ritz(op, b, tr["m"], tr["k"], ar, vectors=False)
        want = want.cpu()
        del b
        for r in records:
            if r["blk"] == blk:
                got = torch.as_tensor(r["vals"], dtype=torch.float64)
                note("ritz_rel_err", float(((got - want).abs() / want.abs()).max()))
        if blk in kept:
            vals, vecs, reported = kept[blk]
            measured = residuals(op, vals.to(vecs.device), vecs).cpu()
            reported = torch.as_tensor(reported, dtype=torch.float64)
            note("residual_max", float(measured.max()))
            note("residual_gap", float((measured - reported).abs().max()))
    return worst


def control(cfg, tr, seed, device, plan_records):
    """The reference in TF32 in the program's place, for the same
    requests: (records, kept) as the driver makes them."""
    ar = Arith("tf32")
    op = _matrix(cfg, seed, device, ar)
    records, kept = [dict(r) for r in plan_records], {}
    for blk in sorted({r["blk"] for r in records}):
        b = inputs.banded_block(op.n, tr["p"], seed, blk, device)
        vals, vecs = ritz(op, b, tr["m"], tr["k"], ar, vectors=True)
        res = residuals(op, vals, vecs)
        for r in records:
            if r["blk"] == blk:
                r["vals"] = vals.double().cpu().numpy()
                r["resid"] = res.double().cpu().numpy()
        kept[blk] = (vals, vecs, res.double().cpu().numpy())
        del b
    return records, kept
