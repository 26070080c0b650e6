"""C1: CGS2 of a block-major block against the stored Krylov basis, as
one schedule of three passes over the basis.

The JAX package has no Pallas kernel here: its `block_cgs2`
(lanczos_tpu/methods/block_lanczos.py:339) is two pairs of `jnp.einsum`,
W -= Q (Q^T W) twice.  Run as two `torch.mm` passes on the card, each
pass is a library SGEMM for the Gram, another for Q^T c and a block-sized
subtract: (4b + 10) blocks of traffic a call against b stored blocks.
The second pass's Gram depends on the first pass's update only row by
row, so the schedule here reads the basis three times, not four:

  A  c1 = Q w^T                                   (b p x p)
  B  w' = w - c1^T Q, and c2 = Q w'^T from the same tile of Q
  C  w'' = w' - c2^T Q, in place on w'

with `total` (the sum over the ranks of a distributed state, the identity
on one device) applied to c1 and c2 between the passes: (3b + 5) blocks a
call.  The arithmetic is CGS2's, in the block's type; only the order of
the sums changes.

`cgs2` chooses the route from what it can observe: on a CUDA float32 or
float64 block with p <= MAX_P it launches cgs2_kernel of
`csrc/lanczos_kernels.cu` once a pass (see its section) and counts
tracing's `cgs2.kernel`; on any other block (a CPU tensor, bfloat16, p >
MAX_P) it runs `cgs2_plain`, the same A / B / C schedule in torch ops.
The launches are set by pure functions, `cgs2_plan` (the tile's rows
staged, the k-slices, the chunks of basis blocks and the ring's stages,
from (b, p, itemsize)), `cgs2_aligned` and `cgs2_blocks`, which the .cu
rechecks.  A basis of more rows than one pass's Gram holds is taken in
chunks of whole blocks, A / C / A / C, each pass once a chunk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.block_dense import _ticket
from lanczos_tpu_torch.utils import tracing

MAX_P = 16  # csrc kCgs2MaxP
THREADS = 512  # csrc kCgs2Threads
WARPS = THREADS // 32
VECTORS = 32  # csrc kCgs2Vectors: 16-byte vectors of a row a tile, one a lane
COLS = 4  # csrc kCgs2Cols: w rows a thread's tile
MAX_STAGES = 6  # csrc kCgs2MaxStages
SMEM = 232_448  # shared memory a block may take on an H100 (227 KB)
GRAM, UPDATE, UPDATE_GRAM = 0, 1, 2  # the .cu's kinds of pass


def slice_rows(itemsize: int) -> int:
    """Basis rows a k-slice sums a Gram over (csrc cgs2_slice_rows): COLS
    times that accumulators a thread, 64 registers of f32 or f64."""
    return 16 if itemsize == 4 else 8


def smem_bytes(rows: int, pw: int, stages: int, itemsize: int) -> int:
    """Shared memory of a pass over `rows` basis rows (csrc
    cgs2_smem_bytes): the ring of rows + pw staged rows of VECTORS 16-byte
    vectors, the update's partials and the coefficients."""
    row = VECTORS * 16
    return stages * (rows + pw) * row + WARPS * COLS * row + rows * pw * itemsize


class Cgs2Plan(NamedTuple):
    pw: int  # w rows padded to whole column quads (COLS)
    slices: int  # k-slices: WARPS over the column quads
    chunk: int  # basis blocks a pass takes at once
    chunks: int  # passes a sweep over the b blocks
    stages: int  # slots of the ring
    smem: int  # bytes of dynamic shared memory a launch

    def launches(self) -> int:
        """Kernel launches of a call: A, B, C; or, in chunks, A / C / A / C
        once a chunk."""
        return 3 if self.chunks == 1 else 4 * self.chunks


@functools.lru_cache(maxsize=None)
def cgs2_plan(b: int, p: int, itemsize: int) -> Cgs2Plan:
    """C1's launch for b basis blocks of p rows of `itemsize`-byte
    elements: p padded to COLS, the warps split over its column quads and
    k-slices, the most rows a Gram's accumulators hold (slices x
    `slice_rows`) and two stages of the ring fit in SMEM, in whole blocks
    (a chunk); the ring as deep as SMEM allows, up to MAX_STAGES."""
    if b < 1 or not 1 <= p <= MAX_P or itemsize not in (4, 8):
        raise ValueError(f"C1 takes b >= 1 blocks of 1..{MAX_P} rows of f32 or f64, "
                         f"got b={b}, p={p}, itemsize={itemsize}")
    pw = -(-p // COLS) * COLS
    slices = WARPS // (pw // COLS)
    rows = slices * slice_rows(itemsize)
    while smem_bytes(rows, pw, 2, itemsize) > SMEM:
        rows -= 1
    chunk = rows // p
    chunks = -(-b // chunk)
    rows = min(b, chunk) * p
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if s == 2 or smem_bytes(rows, pw, s, itemsize) <= SMEM)
    return Cgs2Plan(pw, slices, chunk, chunks, stages,
                    smem_bytes(rows, pw, stages, itemsize))


def cgs2_aligned(S: int, itemsize: int, ptrs) -> bool:
    """Whether every row starts on a 16-byte boundary (each pointer is
    aligned and a row of S elements is a multiple of 16 bytes): C1 then
    copies 16 bytes at once, else element by element into the same tiles."""
    return (S * itemsize) % 16 == 0 and all(ptr % 16 == 0 for ptr in ptrs)


def cgs2_blocks(S: int, itemsize: int, sms: int) -> int:
    """C1's grid: one persistent block an SM, or one a tile (VECTORS
    16-byte vectors of a row) when there are fewer tiles.  A function of S
    on a given card, so every sum adds in the same order on every run."""
    tiles = -(-S // (VECTORS * 16 // itemsize))
    return max(1, min(sms, tiles))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def cgs2_plain(w: torch.Tensor, basis: torch.Tensor, total=_same) -> torch.Tensor:
    """Plain torch version of `cgs2` (same contract): the A / B / C
    schedule as matrix products, which is two passes of w - Q (Q^T w)."""
    p, S = w.shape[0], w[0].numel()
    qf = basis.reshape(-1, S)
    x = w.reshape(p, S)
    c1 = total(qf @ x.T)
    x = x - c1.T @ qf
    c2 = total(qf @ x.T)
    x = x - c2.T @ qf
    return x.reshape(w.shape)


def cgs2(w: torch.Tensor, basis: torch.Tensor, total=_same) -> torch.Tensor:
    """W -= Q (Q^T W), twice, against the basis blocks (b, p, *state) for
    the block-major w (p, *state); `total` sums each (b p, p) coefficient
    block over the ranks of a distributed state.  Returns a new block: C1
    on a CUDA float32 or float64 block with p <= MAX_P, the plain version
    on any other."""
    b, p = basis.shape[0], w.shape[0]
    if b == 0:
        return w
    if not (w.is_cuda and w.dtype in (torch.float32, torch.float64) and p <= MAX_P):
        return cgs2_plain(w, basis, total)
    tracing.count("cgs2.kernel")
    S = w[0].numel()
    x = w.reshape(p, S).contiguous()
    qf = basis.reshape(b * p, S).contiguous()
    out = torch.empty_like(x)
    build.require_cuda("cgs2", x, qf, out)
    itemsize = x.element_size()
    plan = cgs2_plan(b, p, itemsize)
    aligned = cgs2_aligned(S, itemsize, (x.data_ptr(), qf.data_ptr(), out.data_ptr()))
    nblocks = cgs2_blocks(S, itemsize, build.sm_count(x.device))
    c1 = torch.empty((b * p, p), dtype=x.dtype, device=x.device)
    c2 = torch.empty_like(c1)
    partial = torch.empty(nblocks * min(b, plan.chunk) * p * p, dtype=x.dtype,
                          device=x.device)
    ticket, stream = _ticket(x).data_ptr(), build.stream_handle(x)
    row_bytes = S * itemsize

    def launch(kind, lo, hi, src, coeff=None, gram=None):
        """One pass over basis blocks lo..hi-1 (their rows of coeff and
        gram)."""
        build.launch(
            "cgs2", x, "lt_cgs2", build.dtype_code(x), kind,
            qf.data_ptr() + lo * p * row_bytes, (hi - lo) * p, src.data_ptr(), p,
            out.data_ptr(), None if coeff is None else coeff[lo * p:].data_ptr(),
            None if gram is None else gram[lo * p:].data_ptr(), partial.data_ptr(),
            nblocks, ticket, S, int(aligned), plan.pw, plan.slices, plan.stages, plan.smem,
            stream)

    if plan.chunks == 1:
        launch(GRAM, 0, b, x, gram=c1)
        c1 = total(c1).contiguous()
        launch(UPDATE_GRAM, 0, b, x, coeff=c1, gram=c2)
        c2 = total(c2).contiguous()
        launch(UPDATE, 0, b, out, coeff=c2)
        return out.reshape(w.shape)
    spans = [(lo, min(b, lo + plan.chunk)) for lo in range(0, b, plan.chunk)]
    for lo, hi in spans:
        launch(GRAM, lo, hi, x, gram=c1)
    c1 = total(c1).contiguous()
    for lo, hi in spans:
        launch(UPDATE, lo, hi, x if lo == 0 else out, coeff=c1)
    for lo, hi in spans:
        launch(GRAM, lo, hi, out, gram=c2)
    c2 = total(c2).contiguous()
    for lo, hi in spans:
        launch(UPDATE, lo, hi, out, coeff=c2)
    return out.reshape(w.shape)
