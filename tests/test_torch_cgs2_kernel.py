"""C1, the CGS2 kernels (`lanczos_tpu_torch/ops/kernels/cgs2.py`), on the
card (`-m cuda`; they skip without one): against their plain version,
against the same schedule in float64 (the plain version is the two
torch.mm passes they replaced, op for op), in f32 and f64 from 3 rows up to
the assembled eigsh's 10,485,760, with zero rows in w and in the basis,
bases that take chunks, and a split state summed by a stub `total`.  The
plain version itself is held to the JAX package's `block_cgs2` on the CPU
in tests/test_torch_cgs2.py.

Inputs: a basis with orthonormal rows (zero rows past n where b p > n, as
deflated directions are zero), so the result is the projection of w and
no larger than w.  Tolerances, of the scale max |w|: 1e-5 (f32) and 1e-12
(f64) against the plain version and the float64 schedule, which differ
only in the order of the sums (a few units of rounding times sqrt(b p)).
The orthogonality max |Q w''^T| at most twice the plain version's, or 4 eps
of scale where both sit at the rounding floor (a factor of two there is
luck of the rounding)."""

import threading

import pytest
import torch

from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.cgs2 import cgs2, cgs2_plain, cgs2_plan
from lanczos_tpu_torch.utils import tracing

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
PS = (1, 4, 8, 16)


def wide_b(p):
    """A b whose b p rows pass 128: more than one pass's Gram holds at p =
    16 in f32 and at p >= 8 in f64, so those take chunks."""
    return 128 // p + 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: C1 launches only there")
    return torch.device("cuda")


def inputs(b, p, n, dev, dtype, seed=0, zero_rows=False):
    """(w, basis): w (p, n) Gaussian; basis (b, p, n) with orthonormal rows
    in a random order, zero rows past the first n.  zero_rows zeroes w's
    first row and a row of the basis."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = b * p
    if n >= 2**21:  # near-orthonormal: off-diagonal ~ n^-1/2
        q = torch.randn((k, n), generator=g, device=dev, dtype=torch.float64) / n**0.5
    else:
        x = torch.randn((n, min(k, n)), generator=g, device=dev, dtype=torch.float64)
        q = torch.zeros((k, n), device=dev, dtype=torch.float64)
        q[:x.shape[1]] = torch.linalg.qr(x)[0].T
        q = q[torch.randperm(k, generator=g, device=dev)]
    w = torch.randn((p, n), generator=g, device=dev, dtype=torch.float64)
    if zero_rows:
        w[0] = 0.0
        q[min(1, k - 1)] = 0.0
    return w.to(dtype), q.reshape(b, p, n).to(dtype)


def orthogonality(qf, x):
    """max |qf x^T| in float64, each entry a tree sum (torch.sum) of the
    elementwise products: more accurate than a matrix product over n, whose
    own rounding (1e-14 at a million f64 rows) would hide the paths' and
    favour the one that sums in its order."""
    worst = 0.0
    for j in range(x.shape[0]):
        xj = x[j].double()
        for k0 in range(0, qf.shape[0], 16):
            dots = (qf[k0:k0 + 16].double() * xj).sum(dim=1)
            worst = max(worst, float(dots.abs().max()))
    return worst


def check(w, basis):
    dtype = w.dtype
    tol = RTOL[dtype]
    scale = float(w.abs().max()) or 1.0
    build.reset_launches()
    tracing.reset()
    got = cgs2(w, basis)
    torch.cuda.synchronize()
    plan = cgs2_plan(basis.shape[0], w.shape[0], w.element_size())
    assert build.LAUNCHES["cgs2"] == plan.launches()
    assert tracing.counters() == {"cgs2.kernel": 1, "launches.host": plan.launches()}
    assert got.shape == w.shape and got.dtype == dtype
    want = cgs2_plain(w, basis)
    assert float((got - want).abs().max()) <= tol * scale
    f64 = cgs2_plain(w.double(), basis.double())
    assert float((got.double() - f64).abs().max()) <= tol * scale
    qf = basis.reshape(-1, w.shape[1])
    orth, lib = orthogonality(qf, got), orthogonality(qf, want)
    assert orth <= max(2 * lib, 4 * torch.finfo(dtype).eps * scale)
    assert torch.equal(got, cgs2(w, basis))  # the same input, the same bits
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", [3, 1000])
def test_c1_small_states(card, dtype, p, n):
    for b in (1, 2, 7, 12, wide_b(p)):
        w, basis = inputs(b, p, n, card, dtype, seed=b)
        check(w, basis)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", PS)
def test_c1_a_million_and_three_rows(card, dtype, p):
    """A ragged last tile, and rows that are not 16-byte aligned (copied
    element by element)."""
    for b in (1, 7, 12, wide_b(p)):
        w, basis = inputs(b, p, 1_000_003, card, dtype, seed=b)
        check(w, basis)
        del w, basis
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b", [(torch.float32, 1), (torch.float32, 12),
                                     (torch.float32, wide_b(8)), (torch.float64, 12)])
def test_c1_eigsh_rows(card, dtype, b):
    """The assembled eigsh's (8, 10,485,760) state."""
    w, basis = inputs(b, 8, 10_485_760, card, dtype, seed=b)
    check(w, basis)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c1_zero_rows(card, dtype):
    for p, b, n in [(8, 12, 10_000), (4, 3, 1000), (16, 2, 4096)]:
        w, basis = inputs(b, p, n, card, dtype, zero_rows=True)
        got = check(w, basis)
        assert not got[0].any()  # a zero row of w whose basis is orthonormal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c1_split_state_with_a_stub_total(card, dtype):
    """Two half-row shards, each in its own thread, whose `total` sums
    the two shards' coefficient blocks: together the one-device result."""
    p, b, n = 8, 12, 200_000
    w, basis = inputs(b, p, n, card, dtype)
    whole = cgs2(w, basis)
    half = n // 2
    parts = [(w[:, :half].contiguous(), basis[:, :, :half].contiguous()),
             (w[:, half:].contiguous(), basis[:, :, half:].contiguous())]
    slots, barrier, out = [None, None], threading.Barrier(2), [None, None]

    def run(rank):
        def total(c):
            torch.cuda.synchronize()
            slots[rank] = c.clone()
            barrier.wait()
            s = slots[0] + slots[1]
            barrier.wait()
            return s
        out[rank] = cgs2(*parts[rank], total)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = torch.cat(out, dim=1)
    assert float((got - whole).abs().max()) <= RTOL[dtype] * float(w.abs().max())


@pytest.mark.cuda
def test_c1_routes(card):
    """bf16 and p > 16 on the card run the plain version, no launch; an
    empty basis returns w."""
    w, basis = inputs(3, 17, 1000, card, torch.float32)
    tracing.reset()
    build.reset_launches()
    cgs2(w, basis)
    cgs2(w[:8].bfloat16(), basis[:, :8].bfloat16())
    assert cgs2(w, basis[:0]) is w
    assert build.LAUNCHES["cgs2"] == 0 and "cgs2.kernel" not in tracing.counters()
