"""The inputs of every cell, made from `--seed` and handed alike to the
program and to the plain reference.

Nothing here imports the port.  Each input is made on the device it is
used on, from a `torch.Generator` of that device, in a few large calls:
the same seed gives the same inputs on the same kind of device, which is
how the reference, after the window, makes again what the program was
given.
"""

from __future__ import annotations

import hashlib
import random

import torch


def sub_seed(seed: int, *tags) -> int:
    """A seed below 2**63 for one purpose (`tags`) of a run's `seed`:
    independent streams for the matrix, each start block and the plan."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, *tags))
    return g


class Plan:
    """The request stream: for request i, which start block of the pool
    it takes and, where the traffic has a receiver, its flat index lc:
    drawn from lc_range and moved by offsets[i % len(offsets)], the
    offset of the field that request i reads (`receiver_offsets`)."""

    def __init__(self, seed: int, pool: int, lc_range=None, offsets=(0,)):
        self._rng = random.Random(sub_seed(seed, "plan"))
        self.pool = int(pool)
        self.lc_range = lc_range
        self.offsets = list(offsets)
        self._count = 0

    def next(self) -> tuple[int, int | None]:
        blk = self._rng.randrange(self.pool)
        lc = None
        if self.lc_range is not None:
            lo, hi = self.lc_range
            lc = lo + self._rng.randrange(hi - lo + 1)
            lc += self.offsets[self._count % len(self.offsets)]
        self._count += 1
        return blk, lc


def plan(cfg: dict, tr: dict, seed: int) -> Plan:
    """The request stream of a cell, the same for the driver and for the
    control."""
    offsets = receiver_offsets(cfg, tr) if cfg.get("kind") == "maxwell" else (0,)
    return Plan(seed, tr["pool"], cfg.get("lc_range"), offsets)


# -- the Maxwell deployment ----------------------------------------------


def maxwell_unknowns(n: int) -> int:
    """Unknowns of the six staggered field components at grid N: three E
    of N*N*(N+1), three H of N*(N+1)^2."""
    return 3 * n * n * (n + 1) + 3 * n * (n + 1) * (n + 1)


FIELDS = ("E1", "E2", "E3", "H1", "H2", "H3")


def receiver_offsets(cfg: dict, tr: dict) -> list[int]:
    """The flat offset of each field the traffic's requests read in turn
    (`receivers`, default E1 alone, the reference's receiver): E
    components hold N*N*(N+1) unknowns each, H components N*(N+1)^2.  On
    the plane z = 0 an E1 entry and the H2 entry at the same offset share
    (y, x), and there the H2 entry of A u is the operator's coefficient
    times u's E1 entry: an H2 receiver reads the operator at first order
    where an E1 receiver reads it at second."""
    n = int(cfg["n_grid"])
    sizes = [n * n * (n + 1)] * 3 + [n * (n + 1) * (n + 1)] * 3
    starts = [sum(sizes[:i]) for i in range(6)]
    return [starts[FIELDS.index(f)] for f in tr.get("receivers", ["E1"])]


def bump_shifts(cfg: dict, p: int) -> list[float]:
    """The reference's Gaussian-bump family (`build_ell_utils.hpp:228`,
    `:252`): one bump at `single_shift` for a vector, bump i at
    `block_shift_step * (i + 1)` for a block of p."""
    if p == 1:
        return [float(cfg["single_shift"])]
    return [float(cfg["block_shift_step"]) * (i + 1) for i in range(p)]


def maxwell_block(cfg: dict, p: int, seed: int, index: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """Start block `index` of the pool: block-major (p, n), column i the
    bump exp(-(X-cx)^2 - (Y-cy)^2 - (Z-cz)^2) over the state's first
    N*N*(N+1) entries (the reference's indexing: x fastest, then y, then
    z over N + 1 planes; the rest zero), its centre on the family's
    diagonal point moved by up to `jitter` on each axis, drawn from the
    seed.  Made in float64 on the device and rounded once to dtype."""
    n = int(cfg["n_grid"])
    g = generator(seed, "cpu", "bumps", index)
    jitter = float(cfg["jitter"])
    moves = (torch.rand((p, 3), generator=g, dtype=torch.float64) * 2 - 1) * jitter
    centres = torch.tensor(bump_shifts(cfg, p), dtype=torch.float64)[:, None] + moves
    dev = torch.device(device)
    h = 1.0 / (n + 1)
    x = torch.linspace(h, 1.0 - h, n, dtype=torch.float64, device=dev)
    z = torch.linspace(h / 2, 1.0 - h / 2, n + 1, dtype=torch.float64, device=dev)
    size = n * n * (n + 1)
    i = torch.arange(size, device=dev)
    xs, ys, zs = x[i % n], x[(i // n) % n], z[(i // (n * n)) % (n + 1)]
    del i
    c = centres.to(dev)
    out = torch.zeros((p, maxwell_unknowns(n)), dtype=dtype, device=dev)
    for col in range(p):
        r2 = (xs - c[col, 0]) ** 2 + (ys - c[col, 1]) ** 2 + (zs - c[col, 2]) ** 2
        out[col, :size] = torch.exp(-r2).to(dtype)
    return out


# -- the banded deployment ------------------------------------------------


def banded_offsets(cfg: dict, n: int) -> list[int]:
    """The positive offsets of the symmetric band that fit n rows."""
    return [o for o in cfg["offsets"] if 0 < o < n]


def banded_diagonals(cfg: dict, n: int, seed: int, device):
    """The synthetic SuiteSparse-style SPD matrix as its diagonals, made
    on the device: each off-diagonal pair (o, -o) the mean of two draws of
    N(0, 0.25) (the symmetrized random band of `synth_suitesparse_banded`),
    the main diagonal its row's absolute sum + 1, plus five spikes on
    distinct random rows so that the top of the spectrum stands clear.
    Values in float64, rounded once to float32, the type the matrix is
    served in.  Returns (upper: {o: (n - o,) f32}, diag: (n,) f32)."""
    dev = torch.device(device)
    g = generator(seed, dev, "matrix")
    rowsum = torch.zeros(n, dtype=torch.float64, device=dev)
    upper = {}
    for o in banded_offsets(cfg, n):
        pair = torch.randn((2, n - o), generator=g, dtype=torch.float64, device=dev)
        u = (0.5 * 0.5 * (pair[0] + pair[1])).to(torch.float32)
        del pair
        a = u.abs().double()
        rowsum[: n - o] += a
        rowsum[o:] += a
        upper[o] = u
    spikes = torch.tensor(cfg["spikes"], dtype=torch.float64, device=dev)
    rows = torch.randperm(n, generator=g, device=dev)[: spikes.numel()]
    rowsum[rows] += spikes
    diag = (rowsum + 1.0).to(torch.float32)
    return upper, diag


def banded_csr(upper: dict, diag: torch.Tensor):
    """The same matrix as a scipy CSR in float32, rows sorted by column,
    built on the diagonals' device and copied to the host once."""
    import scipy.sparse as sp

    n = diag.numel()
    dev = diag.device
    offs = sorted([-o for o in upper] + [0] + list(upper))
    rows = torch.arange(n, device=dev)
    vals = torch.zeros((n, len(offs)), dtype=torch.float32, device=dev)
    cols = torch.empty((n, len(offs)), dtype=torch.int32, device=dev)
    keep = torch.zeros((n, len(offs)), dtype=torch.bool, device=dev)
    for k, o in enumerate(offs):
        cols[:, k] = (rows + o).to(torch.int32)
        if o == 0:
            vals[:, k] = diag
            keep[:, k] = True
        elif o > 0:
            vals[: n - o, k] = upper[o]
            keep[: n - o, k] = True
        else:
            vals[-o:, k] = upper[-o]
            keep[-o:, k] = True
    del rows
    counts = torch.cumsum(keep.sum(dim=1), 0)
    # scipy keeps one index type for indptr and indices
    index = torch.int32 if int(counts[-1]) < 2**31 else torch.int64
    indptr = torch.zeros(n + 1, dtype=index, device=dev)
    indptr[1:] = counts
    cols = cols.to(index)
    data = vals[keep].cpu().numpy()
    indices = cols[keep].cpu().numpy()
    del vals, cols, keep
    a = sp.csr_matrix((data, indices, indptr.cpu().numpy()), shape=(n, n))
    a.has_sorted_indices = True
    a.has_canonical_format = True
    return a


def banded_block(n: int, p: int, seed: int, index: int, device,
                 dtype=torch.float32) -> torch.Tensor:
    """Start block `index` of the eigsh pool: block-major (p, n) N(0, 1)."""
    g = generator(seed, device, "start", index)
    return torch.randn((p, n), generator=g, dtype=dtype, device=torch.device(device))


def nnz_banded(cfg: dict, n: int) -> int:
    return n + 2 * sum(n - o for o in banded_offsets(cfg, n))
