"""Plain reference of the `expm` driver: m-step block Lanczos with the
reference's symmetric normalization (`methods/block_lanczos.hpp:13-80`;
p = 1 is single-vector Lanczos) and the action expm(t_end A) B read at
the receiver row lc (`test_lanczos.cu:102-113`, `:270-287`; lc may lie in
any field of the flat state), computed on
the reference's own operator (`reference/maxwell.py`) from the same
start blocks the program was given.

Every request of the window is judged: the recurrence does not depend on
lc, so one run per start block of the pool gives the answer at every
receiver.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference.arith import Arith
from portbench.reference.maxwell import Maxwell


def sym(g):
    return 0.5 * (g + g.T)


def block_tridiagonal(alphas, betas):
    """T with alphas on the diagonal and betas[j] below block j (its
    transpose above)."""
    m, p = len(alphas), alphas[0].shape[0]
    t = alphas[0].new_zeros((m * p, m * p))
    for j, a in enumerate(alphas):
        t[j * p:(j + 1) * p, j * p:(j + 1) * p] = a
    for j, b in enumerate(betas):
        t[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = b
        t[j * p:(j + 1) * p, (j + 1) * p:(j + 2) * p] = b.T
    return t


def answers(op, b: torch.Tensor, m: int, t_end: float, lcs, ar: Arith) -> dict:
    """{lc: (p,) float64 ndarray} of row lc of expm(t_end A) B by m-step
    block Lanczos on the block-major start block b (p, n)."""
    lcs = sorted(set(lcs))
    q = b.to(ar.dtype)
    beta0, inv = ar.sqrtm_invsqrtm(ar.mm(q, q.T))
    q = ar.mm(inv, q)
    w = op.mm(q)
    alpha = sym(ar.mm(w, q.T))
    w = w - ar.mm(alpha, q)
    alphas, betas, traces = [alpha], [], [q[:, lcs]]
    for _ in range(1, m):
        beta, inv = ar.sqrtm_invsqrtm(ar.mm(w, w.T))
        q_prev, q = q, ar.mm(inv, w)
        w = op.mm(q) - ar.mm(beta, q_prev)
        del q_prev
        alpha = sym(ar.mm(w, q.T))
        w = w - ar.mm(alpha, q)
        alphas.append(alpha)
        betas.append(beta)
        traces.append(q[:, lcs])
    p = b.shape[0]
    e = ar.expm_sym(t_end * block_tridiagonal(alphas, betas))
    f = ar.mm(e[:, :p], beta0)  # expm(tT) E_1 sqrtm(B^T B)
    tr = torch.stack(traces)  # (m, p, L)
    out = {}
    for i, lc in enumerate(lcs):
        out[lc] = ar.mm(tr[:, :, i].reshape(1, -1), f)[0].double().cpu().numpy()
    return out


def _run(cfg, tr, seed, device, plan_records, mode):
    """The reference's answers {(blk, lc): (p,)} for every (blk, lc)
    among the records, in `mode`."""
    ar = Arith(mode)
    op = Maxwell(int(cfg["n_grid"]), ar)
    by_blk = {}
    for r in plan_records:
        by_blk.setdefault(r["blk"], set()).add(r["lc"])
    out = {}
    for blk, lcs in sorted(by_blk.items()):
        b = inputs.maxwell_block(cfg, tr["p"], seed, blk, device)
        for lc, a in answers(op, b, tr["m"], cfg["t_end"], lcs, ar).items():
            out[blk, lc] = a
        del b
    return out


def judge(cfg, tr, seed, device, records, kept) -> dict:
    """The largest ||answer - reference|| / ||reference|| over every
    request of the window: answer_rel_err over the requests read at an E
    receiver, h_answer_rel_err over those read at an H receiver (there
    are none unless the traffic names an H field)."""
    ref = _run(cfg, tr, seed, device, records, "f64")
    n = int(cfg["n_grid"])
    e_rows = 3 * n * n * (n + 1)
    worst = {}
    for r in records:
        want = ref[r["blk"], r["lc"]]
        got = np.asarray(r["answer"], dtype=np.float64)
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        name = "answer_rel_err" if r["lc"] < e_rows else "h_answer_rel_err"
        worst[name] = max(worst.get(name, 0.0), err) if np.isfinite(err) else float("inf")
    return worst


def control(cfg, tr, seed, device, plan_records):
    """The reference in TF32 in the program's place: records as the
    driver makes them, for the same requests."""
    got = _run(cfg, tr, seed, device, plan_records, "tf32")
    return [dict(r, answer=got[r["blk"], r["lc"]]) for r in plan_records], {}
