"""Plain reference of the `eigsh_sharded` driver: the algorithm of
`reference/eigsh.py` (m-step block Lanczos, QR normalization, full
re-orthogonalization by two classical Gram-Schmidt passes against every
stored block, the top-k Ritz pairs, measured residuals) with its rows
split over the ranks of the group as the program's are, in plain
`torch.distributed`:

- the banded matrix as its diagonals over the rank's rows
  (`shards.rank_diagonals`), one halo exchange a product (an all-gather
  of every rank's edge rows);
- each Gram and CGS coefficient block computed on the rank's rows and
  all-reduced;
- each QR a local `torch.linalg.qr`, an all-gather of the R factors and
  a QR of their stack;
- a residual's squared norms summed over the ranks;
- the program's own product of start block 0, on the rows next to each
  shard edge and a sample of the rest (`shards.probe_rows`), against the
  band's, row by row: the Ritz pairs sit on the band's spikes and do not
  see a halo row lost elsewhere, this does.

Every rank ends with the same T, so the same Ritz values.  TF32 is off
(`Arith`).  Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from portbench import inputs, shards
from portbench.reference.arith import Arith
from portbench.reference.expm import block_tridiagonal, sym


class RankBand:
    """The rank's rows of the band in `ar`'s arithmetic, applied to
    block-major (p, rows_loc) states (rows past the matrix's end zero)."""

    def __init__(self, coef: dict, halo: int, rows_loc: int, ar: Arith, group):
        self.ar, self.halo, self.rows_loc, self.group = ar, int(halo), int(rows_loc), group
        self.coef = {}
        for o, c in coef.items():
            full = torch.zeros(rows_loc, dtype=ar.dtype, device=c.device)
            full[: c.numel()] = c.to(ar.dtype)
            self.coef[o] = ar.r(full)

    def mm(self, x: torch.Tensor, absolute: bool = False) -> torch.Tensor:
        """A x; absolute: |A| x, each coefficient's magnitude."""
        h, rl = self.halo, self.rows_loc
        w = window(self.ar.r(x.to(self.ar.dtype)), h, self.group)
        f = torch.abs if absolute else (lambda c: c)
        y = f(self.coef[0]) * w[:, h : h + rl]
        for o, c in self.coef.items():
            if o:
                y += f(c) * w[:, h + o : h + o + rl]
        return y


def window(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """`x` (p, rows_loc), this rank's rows, with `halo` rows of the
    neighbours' on either side (zeros past the ends), by one all-gather of
    every rank's first and last min(halo, rows_loc) rows; a halo wider
    than a shard takes whole blocks of the ranks up to ceil(halo /
    rows_loc) away."""
    if halo == 0:
        return x
    p, rl = x.shape
    e = min(halo, rl)
    edges = torch.cat([x[:, :e], x[:, rl - e :]], dim=1).contiguous()
    parts = [torch.empty_like(edges) for _ in range(group.size)]
    dist.all_gather(parts, edges, group=group.process_group)
    hops = -(-halo // rl)
    zeros = x.new_zeros((p, e))
    r = group.rank
    left = [parts[r - k][:, e:] if r - k >= 0 else zeros for k in range(hops, 0, -1)]
    right = [parts[r + k][:, :e] if r + k < group.size else zeros for k in range(1, hops + 1)]
    return torch.cat([torch.cat(left, dim=1)[:, -halo:], x,
                      torch.cat(right, dim=1)[:, :halo]], dim=1)


def _total(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group.process_group)
    return t


def _qr(x: torch.Tensor, ar: Arith, group):
    """(q (p, rows_loc) this rank's rows, r (p, p) the same on every rank)
    of the block-major x split over the ranks."""
    p = x.shape[0]
    ql, rl = torch.linalg.qr(x.T)
    parts = [torch.empty_like(rl) for _ in range(group.size)]
    dist.all_gather(parts, rl.contiguous(), group=group.process_group)
    q2, r = torch.linalg.qr(torch.cat(parts, dim=0))
    q = ar.mm(ql, q2[group.rank * p : (group.rank + 1) * p])
    return q.T.contiguous(), r


def ritz(op: RankBand, b: torch.Tensor, m: int, k: int, ar: Arith, group, vectors: bool):
    """(values (k,), this rank's rows of the vectors (k, rows_loc) or
    None) of the k largest Ritz values; b: this rank's (p, rows_loc)."""
    p, rl = b.shape
    basis = torch.empty((m, p, rl), dtype=ar.dtype, device=b.device)

    def gram(w, q):
        return _total(ar.mm(w, q.T), group)

    def cgs2(w, upto):
        qf = basis[:upto].reshape(upto * p, rl)
        for _ in range(2):
            w = w - ar.mm(gram(w, qf), qf)
        return w

    basis[0], _ = _qr(b.to(ar.dtype), ar, group)
    w = op.mm(basis[0])
    alpha = sym(gram(w, basis[0]))
    w = cgs2(w - ar.mm(alpha, basis[0]), 1)
    alphas, betas = [alpha], []
    for j in range(1, m):
        basis[j], r = _qr(w, ar, group)
        w = op.mm(basis[j]) - ar.mm(r, basis[j - 1])
        alpha = sym(gram(w, basis[j]))
        w = cgs2(w - ar.mm(alpha, basis[j]), j + 1)
        alphas.append(alpha)
        betas.append(r)
    del w
    vals, s = torch.linalg.eigh(block_tridiagonal(alphas, betas))
    idx = torch.argsort(vals, descending=True)[:k]
    vecs = ar.mm(s[:, idx].T, basis.reshape(m * p, rl)) if vectors else None
    return vals[idx], vecs


def residuals(op: RankBand, vals: torch.Tensor, vecs: torch.Tensor, group) -> torch.Tensor:
    """||A y_i - theta_i y_i|| / (|theta_i| ||y_i||) in op's arithmetic,
    vecs (k, rows_loc) this rank's rows, the squared norms summed over
    the ranks."""
    ar = op.ar
    y = vecs.to(ar.dtype)
    th = vals.to(ar.dtype)[:, None]
    r, yr = ar.r(op.mm(y) - ar.mul(th, y)), ar.r(y)
    sq = _total(torch.stack([torch.sum(r * r, dim=1), torch.sum(yr * yr, dim=1)]), group)
    return torch.sqrt(sq[0]) / (th[:, 0].abs() * torch.sqrt(sq[1]))


def rank_operator(cfg, seed, device, ar: Arith, group) -> tuple[RankBand, int, int]:
    """(this rank's operator, lo, hi): the whole band's diagonals made on
    the card from the seed, this rank's rows kept."""
    n = int(cfg["rows"])
    lo, hi, rows_loc = shards.bounds(n, group.size, group.rank)
    upper, diag = inputs.banded_diagonals(cfg, n, seed, device)
    coef = shards.rank_diagonals(upper, diag, lo, hi)
    del upper, diag
    return RankBand(coef, max(inputs.banded_offsets(cfg, n)), rows_loc, ar, group), lo, hi


def rank_block(cfg, tr, seed, blk: int, device, lo: int, hi: int,
               rows_loc: int) -> torch.Tensor:
    """This rank's (p, rows_loc) rows of start block `blk` (zeros past hi)."""
    b = inputs.banded_block(int(cfg["rows"]), int(tr["p"]), seed, blk, device)
    return padded(b[:, lo:hi], rows_loc)


def padded(x: torch.Tensor, rows_loc: int) -> torch.Tensor:
    """(k, rows) -> (k, rows_loc), zeros after the rows."""
    out = x.new_zeros((x.shape[0], rows_loc))
    out[:, : x.shape[1]] = x
    return out


def apply_rel_err(op: RankBand, b: torch.Tensor, lo: int, rows: torch.Tensor,
                  got: torch.Tensor, group) -> float:
    """The worst over the ranks, the rows and the columns of |got - (A b)_i|
    / (|A| |b|)_i: the program's rows `rows` (global) of A b, b this
    rank's (p, rows_loc) rows of a start block, against op's.  A sound
    product reads float32's rounding over a row's 11 terms; a halo row
    lost, zeroed or left from an earlier product reads its share of the
    row, percents."""
    at = rows.to(b.device) - lo
    want = op.mm(b)[:, at]
    scale = op.mm(b.abs(), absolute=True)[:, at]
    err = ((got.to(want) - want).abs() / scale).max().reshape(1)
    if not torch.isfinite(err):
        err.fill_(float("inf"))
    dist.all_reduce(err, op=dist.ReduceOp.MAX, group=group.process_group)
    return float(err)


def judge(cfg, tr, seed, device, records, kept, group) -> dict:
    """The readings of `reference/eigsh.py`'s judge, over the ranks:
    ritz_rel_err (the Ritz values, the same on every rank), residual_max
    and residual_gap (a kept pair's residual measured over every rank's
    rows), and apply_rel_err, the program's product of start block 0 on
    the rows `shards.probe_rows` picks (`apply_rel_err`; inf where the
    program kept none).  kept: {blk: (vals (k,), this rank's rows of the
    vectors (k, hi - lo), reported residuals (k,)), "apply": (rows,
    their (p, rows.numel()) values of A b)}."""
    ar = Arith("f64")
    op, lo, hi = rank_operator(cfg, seed, device, ar, group)
    worst = {"ritz_rel_err": 0.0, "residual_max": 0.0, "residual_gap": 0.0,
             "apply_rel_err": float("inf")}

    def note(name, x):
        worst[name] = max(worst[name], x) if x == x else float("inf")

    kept = dict(kept)
    probe = kept.pop("apply", None)
    if probe is not None:
        b = rank_block(cfg, tr, seed, 0, device, lo, hi, op.rows_loc)
        worst["apply_rel_err"] = apply_rel_err(op, b, lo, *probe, group)
        del b
    for blk in sorted({r["blk"] for r in records} | set(kept)):
        b = rank_block(cfg, tr, seed, blk, device, lo, hi, op.rows_loc)
        want, _ = ritz(op, b, int(tr["m"]), int(tr["k"]), ar, group, vectors=False)
        want = want.cpu()
        del b
        for r in records:
            if r["blk"] == blk:
                got = torch.as_tensor(r["vals"], dtype=torch.float64)
                note("ritz_rel_err", float(((got - want).abs() / want.abs()).max()))
        if blk in kept:
            vals, vecs, reported = kept[blk]
            measured = residuals(op, vals.to(device), padded(vecs.to(device), op.rows_loc),
                                 group).cpu()
            reported = torch.as_tensor(reported, dtype=torch.float64)
            note("residual_max", float(measured.max()))
            note("residual_gap", float((measured - reported).abs().max()))
    return worst
