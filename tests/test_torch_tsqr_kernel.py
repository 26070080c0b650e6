"""T1, the Householder TSQR kernel (`lanczos_tpu_torch/ops/kernels/tsqr.py`),
on the card (`-m cuda`; they skip without one): against its plain version
and against `probes.library_tsqr`, the batched `torch.linalg.qr` tree it
replaced, in f32 and f64 from tiny shapes up to the assembled eigsh's
10,485,760 x 8, and on columns whose squares under- or overflow.  The plain version itself is held to the JAX package and
NumPy on the CPU in tests/test_torch_eigs.py.

Tolerances: the factors' errors, ||A - QR|| / ||A|| and max |Q^T Q - I|,
at most twice the library's on the same input, or a few units of
rounding (4 eps), whichever is larger: both are eps-level, and at that
level a factor of two is luck of the rounding.  Against the plain version,
which takes the same reflections and sums them in another order: 1e-4
(f32) and 1e-12 (f64) of scale on well-conditioned blocks (singular
values 1 to 10)."""

import numpy as np
import pytest
import torch

from lanczos_tpu_torch.ops import tsqr as tsqr_mod
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.tsqr import householder_tsqr, tile_tree_plain, tsqr_plan
from lanczos_tpu_torch.probes import library_tsqr, qr_errors
from lanczos_tpu_torch.utils import tracing

RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
SHAPES = [(3, 17), (6, 1000), (1, 2049), (8, 5000), (16, 3000), (8, 1_000_003),
          (8, 10_485_760)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: T1 launches only there")
    return torch.device("cuda")


def block(p, n, dev, dtype, cond=10.0, seed=0):
    """A block-major (p, n) block with singular values from 1 down to 1/cond."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((p, n), generator=g, device=dev, dtype=torch.float64)
    u = torch.linalg.qr(x.T)[0].T
    v = torch.linalg.qr(torch.randn((p, p), generator=g, device=dev,
                                    dtype=torch.float64))[0]
    s = torch.logspace(0, -np.log10(cond), p, device=dev, dtype=torch.float64)
    return ((v * s) @ u).to(dtype).contiguous()


def within_library(x, q, r):
    eps = torch.finfo(x.dtype).eps
    got, lib = qr_errors(x, q, r), qr_errors(x, *library_tsqr(x))
    for name, g, w in zip(("recon", "orth"), got, lib):
        assert g <= max(2 * w, 4 * eps), f"{name}: T1 {g:.3e}, library {w:.3e}"
    assert torch.equal(r, torch.triu(r))
    assert bool((torch.diagonal(r) >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,n", SHAPES)
def test_t1_matches_plain_and_library(card, p, n, dtype):
    x = block(p, n, card, dtype)
    q, r = householder_tsqr(x)
    torch.cuda.synchronize()
    within_library(x, q, r)
    qp, rp = tile_tree_plain(x, tsqr_plan(n, p, x.element_size()))
    tol = RTOL[dtype]
    assert float((q - qp).abs().max()) <= tol * float(qp.abs().max())
    assert float((r - rp).abs().max()) <= tol * float(rp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_t1_deep_trees_and_ragged_tiles(card, dtype):
    """Tiles of ceil(n / n_chunks) rows: deeper trees, and a last tile
    with fewer rows than p."""
    for p, n, chunks in [(8, 4100, 9), (5, 9000, 20), (3, 2049, 3), (8, 100_003, 3000)]:
        x = block(p, n, card, dtype, seed=n)
        plan = tsqr_plan(n, p, x.element_size(), chunks)
        q, r = householder_tsqr(x, plan=plan)
        within_library(x, q, r)
        qp, rp = tile_tree_plain(x, plan)
        assert float((q - qp).abs().max()) <= RTOL[dtype] * float(qp.abs().max())


@pytest.mark.cuda
def test_t1_ill_conditioned_f32_stays_orthonormal(card):
    """Singular values 1 down to 1e-4 (the cell's breakdown_eps): q stays
    orthonormal to the eps level the library reads, where a Gram-based QR
    (condition squared, 1e8 past float32's 1 / eps) would not."""
    x = block(8, 10_485_760, card, torch.float32, cond=1e4, seed=3)
    q, r = householder_tsqr(x)
    within_library(x, q, r)
    assert qr_errors(x, q, r)[1] < 50 * torch.finfo(torch.float32).eps


SCALES = [(torch.float32, 1e-25), (torch.float32, 1e20), (torch.float64, 1e-170),
          (torch.float64, 1e170)]
MIXED = {torch.float32: [1e10, 1e28, 1e-25, 1.0, 1e20, 1e-20],
         torch.float64: [1e150, 1e300, 1e-300, 1.0, 1e170, 1e-170]}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["whole", "alternate", "mixed"])
@pytest.mark.parametrize("dtype,scale", SCALES)
def test_t1_scales_tiny_and_huge_columns(card, dtype, scale, layout):
    """Columns whose squares underflow or overflow (tests/test_torch_eigs.py's
    cases at 1,000,003 rows: the whole block, every other column, or
    columns of each kind side by side): T1 factors those tiles again with
    their columns scaled, as its plain version does.  Each column of x.T -
    q.T r at rounding level of that column, q orthonormal, the plain
    version's factors, and R alone the same R."""
    p, n = 6, 1_000_003
    g = torch.Generator(device=card).manual_seed(7)
    cols = {"whole": [scale] * p, "alternate": [1.0, scale] * (p // 2),
            "mixed": MIXED[dtype]}[layout]
    cols = torch.tensor(cols, dtype=torch.float64, device=card)
    x = (torch.randn((p, n), generator=g, device=card, dtype=torch.float64)
         * cols[:, None]).to(dtype)
    q, r = householder_tsqr(x)
    _, r_only = householder_tsqr(x, want_q=False)
    qp, rp = tile_tree_plain(x, tsqr_plan(n, p, x.element_size()))
    torch.cuda.synchronize()
    eps = torch.finfo(dtype).eps
    # the columns unscaled first: their squares are outside float64's range too
    xd, rd, rpd = x.double() / cols[:, None], r.double() / cols, rp.double() / cols
    err = (xd - rd.T @ q.double()).norm(dim=1)
    assert bool((err <= 50 * eps * xd.norm(dim=1)).all()), err
    orth = float((q.double() @ q.double().T - torch.eye(p, dtype=torch.float64, device=card)).abs().max())
    assert orth <= 50 * eps
    assert float((q - qp).abs().max()) <= RTOL[dtype] * float(qp.abs().max())
    assert float((rd - rpd).abs().max()) <= RTOL[dtype] * float(rpd.abs().max())
    assert torch.equal(r, r_only) and torch.equal(r, torch.triu(r))
    assert bool((torch.diagonal(r) >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_t1_writes_block_major_and_counts(card, dtype):
    """q comes back (p, n) contiguous; an R-only call gives the same R;
    tsqr_rows counts `tsqr.kernel` with `tsqr.calls`, and the launches
    are the plan's."""
    p, n = 8, 1_000_003
    x = block(p, n, card, dtype)
    plan = tsqr_plan(n, p, x.element_size())
    assert plan.launches() == 5 and plan.launches(False) == 3
    build.reset_launches()
    tracing.reset()
    q, r = tsqr_mod.tsqr_rows(x)
    _, r_only = tsqr_mod.tsqr_rows(x, want_q=False)
    torch.cuda.synchronize()
    assert q.shape == (p, n) and q.is_contiguous()
    assert torch.equal(r, r_only)
    assert build.LAUNCHES["tsqr"] == plan.launches() + plan.launches(False)
    assert tracing.counters() == {"tsqr.calls": 2, "tsqr.kernel": 2,
                                  "launches.host": build.LAUNCHES["tsqr"]}
    # past the kernel's widths the plain version runs, on the card
    tracing.reset()
    tsqr_mod.tsqr_rows(block(17, 5000, card, dtype))
    assert tracing.counters() == {"tsqr.calls": 1}
