"""T1: the tall-skinny QR of a block-major (p, n) state by a tree of
Householder QRs of row tiles.

The JAX package has no Pallas kernel here: its `tsqr` is a vmapped
`jnp.linalg.qr` over 8 chunks and one of their stacked R factors
(lanczos_tpu/ops/tsqr.py).  Batched `torch.linalg.qr` runs that on the
card as cuSOLVER's unblocked panel QR over 8 very tall panels, a few SMs
walking 1.3M rows each; T1 replaces it.

The tree (the same in the kernel and in `tile_tree_plain`): split the n
rows into tiles of `tile` rows (the last one ragged), QR each tile by p
Householder reflections and stack the tiles' p x p R factors; QR that
stack the same way, level by level, until one tile is left, the root.
The root's R with its signs fixed (diag(R) >= 0) is the answer's R; the
sign matrix D is the root's own factor.  Then the explicit factors go
down the tree: each tile forms its Q (rows x p) times the p x p factor
the level above gives it, and those rows are the factors of the level
below; at the leaves they are q.  A call that wants only R stops at the
root.  A tile whose sums may under- or overflow (`_householder`'s wild
tiles) is factored again with each column scaled by a power of two
(`_tile_qr`): exact, and the reflections do not change with a column's
scale, so only R's columns are scaled back.

`householder_tsqr` chooses the route from what it can observe: on a CUDA
float32 or float64 state with p <= MAX_P it runs tsqr_tile_kernel of
`csrc/lanczos_kernels.cu` once per level and pass (see its section; the
leaf passes read the state in place, block-major, and the last one
writes q block-major) and counts tracing's `tsqr.kernel`; on any other
state (a CPU tensor, bfloat16, p > MAX_P) it runs `tile_tree_plain`, the
op-by-op torch version the kernel follows, on the state's device (the
kernel sums each reduction in a tree across the block, so the two differ
in rounding only).  The launches are set by a pure function, `tsqr_plan`,
which the .cu rechecks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.utils import tracing

MAX_P = 16
WIDTHS = (4, 8, 16)  # csrc tsqr_width's: p is padded up to one of these
THREADS = 256  # csrc kTsqrThreads
REGISTERS = 32  # 32-bit registers of tile values a thread holds


class TsqrPlan(NamedTuple):
    width: int  # the kernel's compiled width (p padded), 0 past MAX_P
    tile: int  # rows a tile
    levels: tuple  # rows of each level's input: n, then the R stacks; the last is the root

    def launches(self, want_q: bool = True) -> int:
        """Kernel launches of a call: a QR pass a level below the root,
        the root, and with q an apply pass a level below the root."""
        h = len(self.levels) - 1
        return 2 * h + 1 if want_q else h + 1


def _width(p: int) -> int:
    return next((w for w in WIDTHS if p <= w), 0)


def tile_rows(p: int, itemsize: int) -> int:
    """The most rows a tile holds at p: THREADS threads of REGISTERS
    32-bit registers of tile values each, p padded to the kernel's width
    (64 rows a column past MAX_P, where only the plain version runs)."""
    width = _width(p)
    if not width:
        return 64 * p
    values = REGISTERS // max(1, itemsize // 4)
    return THREADS * (values // width)


def tsqr_plan(n: int, p: int, itemsize: int, n_chunks: int | None = None) -> TsqrPlan:
    """T1's tree for an (n, p) block of `itemsize`-byte elements: tiles of
    `tile_rows(p, itemsize)` rows, or of ceil(n / n_chunks) rows when
    n_chunks is given (at least 2p, so every level halves, and at most
    tile_rows); each level's input rows, n first, until one tile holds
    them."""
    if p < 1 or n < p:
        raise ValueError(f"TSQR takes an (n, p) block with 1 <= p <= n, got ({n}, {p})")
    cap = tile_rows(p, itemsize)
    tile = cap if n_chunks is None else -(-n // n_chunks)
    if not 2 * p <= tile <= cap:
        raise ValueError(
            f"TSQR tiles hold {2 * p} to {cap} rows at p={p}, got {tile} "
            f"({n} rows in {n_chunks} chunks)")
    levels = [n]
    while levels[-1] > tile:
        levels.append(-(-levels[-1] // tile) * p)
    return TsqrPlan(_width(p), tile, tuple(levels))


# -- the plain version --------------------------------------------------------


def _tiles(a: torch.Tensor, tile: int) -> torch.Tensor:
    """(rows, p) -> (tiles, tile, p), the last tile zero-padded."""
    rows, p = a.shape
    t = -(-rows // tile)
    pad = torch.zeros((t * tile - rows, p), dtype=a.dtype, device=a.device)
    return torch.cat([a, pad]).reshape(t, tile, p)


def _tiny(dtype) -> float:
    """The least x^2 plus sum of squares below the pivot that a tile's
    reflections take unscaled: the smallest normal number over eps^2
    (2^-80 in float32), so that terms lost below the normal range cost
    under eps of it (csrc tsqr_tiny)."""
    f = torch.finfo(dtype)
    return f.tiny / f.eps**2


def _householder(a: torch.Tensor):
    """Householder QR of each tile of a (t, L, p), LAPACK's reflections
    (dlarfg: beta = -sign(x) ||x||, v[k] = 1, no reflection where the
    column below the diagonal is zero).  Returns (a, tau, g, wild): a holds
    R on and above the diagonal and the scaled reflectors v below it; tau
    (t, p); g (t, p, p) with g[i, k] = v_i^T v_k for i < k, zero
    elsewhere; wild (t,) the tiles where a reflection's sums may under- or
    overflow: x^2 plus the squares below the pivot under `_tiny` and not
    all zero, or a sum for j >= k not finite."""
    a = a.clone()
    t, _, p = a.shape
    tau = torch.zeros((t, p), dtype=a.dtype, device=a.device)
    g = torch.zeros((t, p, p), dtype=a.dtype, device=a.device)
    wild = torch.zeros(t, dtype=torch.bool, device=a.device)
    tiny = _tiny(a.dtype)
    for k in range(p):
        below = a[:, k + 1:, :]
        # s_j = sum over rows r > k of a[r, k] a[r, j]: for j >= k the
        # column sums of the reflection, for j < k v_j^T a[:, k] (g)
        s = (below[:, :, k:k + 1] * below).sum(dim=1)
        x, row = a[:, k, k], a[:, k, :]
        nn = x * x + s[:, k]
        zero = (x == 0) & (s[:, k] == 0)
        wild |= (~(nn >= tiny) & ~zero) | ~torch.isfinite(nn) | ~torch.isfinite(s[:, k:]).all(dim=1)
        reflect = s[:, k] != 0
        norm = torch.sqrt(nn)
        alpha = torch.where(reflect, torch.where(x >= 0, -norm, norm), x)
        one = torch.ones_like(x)
        tau_k = torch.where(reflect, (alpha - x) / torch.where(reflect, alpha, one), 0.0)
        inv = torch.where(reflect, 1.0 / torch.where(reflect, x - alpha, one), 0.0)
        c = tau_k[:, None] * (s[:, k + 1:] * inv[:, None] + row[:, k + 1:])
        v = below[:, :, k] * inv[:, None]
        g[:, :k, k] = s[:, :k] * inv[:, None] + row[:, :k]
        a[:, k + 1:, k + 1:] -= v[:, :, None] * c[:, None, :]
        a[:, k, k + 1:] -= c
        a[:, k, k] = alpha
        a[:, k + 1:, k] = v
        tau[:, k] = tau_k
    return a, tau, g, wild


def _tile_qr(tiles: torch.Tensor):
    """`_householder` of the tiles (t, L, p); a wild tile is factored again
    with each column j scaled by 2^-e_j, its largest entry then in [0.5,
    1).  That is exact, and the reflections (v, tau, g) do not change with
    a column's scale: only R's columns are scaled back.  Returns (a, tau,
    g)."""
    a, tau, g, wild = _householder(tiles)
    if not bool(wild.any()):
        return a, tau, g
    _, e = torch.frexp(tiles.abs().amax(dim=1))
    scale = torch.where(wild[:, None], torch.ldexp(torch.ones_like(tiles[:, 0, :]), -e), 1.0)
    a2, tau2, g2, _ = _householder(tiles * scale[:, None, :])
    p = tiles.shape[2]
    top = torch.triu(a2[:, :p, :]) / scale[:, None, :] + torch.tril(a2[:, :p, :], -1)
    a2 = torch.cat([top, a2[:, p:, :]], dim=1)
    w = wild[:, None]
    return (torch.where(w[:, :, None], a2, a), torch.where(w, tau2, tau),
            torch.where(w[:, :, None], g2, g))


def _explicit_q(a, tau, g, f):
    """Each tile's H_0 ... H_{p-1} [F; 0] (t, L, p) by the compact WY form
    I - V T V^T: T from tau and g (dlarft), then [F; 0] - V (T (V_top^T
    F)), V_top the tile's first p rows of V (unit lower triangular)."""
    t, rows, p = a.shape
    tm = torch.zeros((t, p, p), dtype=a.dtype, device=a.device)
    for k in range(p):
        tm[:, k, k] = tau[:, k]
        tm[:, :k, k] = -tau[:, k:k + 1] * (tm[:, :k, :k] @ g[:, :k, k:k + 1])[:, :, 0]
    eye = torch.eye(p, dtype=a.dtype, device=a.device)
    v = torch.cat([torch.tril(a[:, :p, :], -1) + eye, a[:, p:, :]], dim=1)
    m = tm @ (v[:, :p, :].transpose(1, 2) @ f)
    y = -(v @ m)
    y[:, :p, :] += f
    return y


def tile_tree_plain(x: torch.Tensor, plan: TsqrPlan, want_q: bool = True):
    """Plain torch version of `householder_tsqr` (same contract) on the
    tree of `plan`."""
    p = x.shape[0]
    stack, kept = x.T, []
    for _ in plan.levels:
        a, tau, g = _tile_qr(_tiles(stack, plan.tile))
        kept.append((a, tau, g))
        stack = torch.triu(a[:, :p, :]).reshape(-1, p)
    # the root's R, its signs fixed by D, which is the root's factor
    d = torch.where(torch.diagonal(stack) < 0, -1.0, 1.0).to(x.dtype)
    r = stack * d[:, None]
    if not want_q:
        return None, r
    y = torch.diag(d)
    for (a, tau, g), rows in zip(reversed(kept), reversed(plan.levels)):
        y = _explicit_q(a, tau, g, y.reshape(-1, p, p)).reshape(-1, p)[:rows]
    return y.T.contiguous(), r


# -- the kernel ------------------------------------------------------------------


def householder_tsqr(x: torch.Tensor, want_q: bool = True, plan: TsqrPlan | None = None):
    """QR of the block-major x (p, n), the transpose of a tall (n, p)
    block: (q, r) with q (p, n) block-major and orthonormal rows (None
    when want_q is False), r (p, p) upper triangular with a non-negative
    diagonal, x.T = q.T @ r.  T1 on a CUDA float32 or float64 block with
    p <= MAX_P (contiguous, else it raises), the plain version on any
    other; `plan` the tree, by default `tsqr_plan(n, p, itemsize)`."""
    if x.ndim != 2:
        raise ValueError(f"householder_tsqr takes a (p, n) block, got {tuple(x.shape)}")
    p, n = x.shape
    if plan is None:
        plan = tsqr_plan(n, p, x.element_size())
    if not (x.is_cuda and x.dtype in (torch.float32, torch.float64) and plan.width):
        return tile_tree_plain(x, plan, want_q)
    tracing.count("tsqr.kernel")
    r = torch.empty((p, p), dtype=x.dtype, device=x.device)
    q = torch.empty_like(x) if want_q else None
    work = torch.empty(p * sum(plan.levels[1:]), dtype=x.dtype, device=x.device)
    build.require_cuda("tsqr", x, r, work, *(() if q is None else (q,)))
    levels = (ctypes.c_longlong * len(plan.levels))(*plan.levels)
    build.launch(
        "tsqr", x, "lt_tsqr", build.dtype_code(x), x.data_ptr(),
        None if q is None else q.data_ptr(), r.data_ptr(), work.data_ptr(),
        levels, len(plan.levels), p, plan.width, plan.tile,
        build.stream_handle(x), count=plan.launches(want_q),
    )
    return q, r
