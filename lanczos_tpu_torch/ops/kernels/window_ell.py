"""K8: the windowed-ELL SpMM, Y = A X on the planes of `ops/window_ell.py`.

Port of `_windowed_spmm` (lanczos_tpu/ops/pallas/window_ell.py:691, kernel
`_spmm_kernel` at :624).  For output row r in chunk c = r // 128, lane
l = r % 128, and each block column j < p:

    Y[j, r] = sum_{k < ppc} data[c*ppc + k, l]
              * X[j, wb[c // (cpb*spg)] + off[c*ppc + k]*128 + lidx[c*ppc + k, l]]

Rows up to n128 = C_pad*128 are written, the zero pad included.

The Pallas kernel stages each group's band of x in VMEM with a double-
buffered DMA and rebuilds the gather from two 128-lane register selects,
because the TPU cannot gather.  A GPU gathers natively: windowed_spmm_kernel
gives a warp one 128-row chunk and a lane four of its rows, reads each
plane's values and uint8 indices as 16-byte and 4-byte loads, issues the
next planes' loads before this plane's gathers, and gathers x through the
read-only path, where L1 and L2 serve a plane's 256-wide window; one launch
covers up to 8 columns.  It has no bounds logic: the plan keeps every
column in the group's band, below n128 (`WindowedEllMatrix` checks it once
per plan); empty slots are value 0 at index 0.  Device memory bounds it:
the planes, their indices and offsets, and one read of X and one write of
Y.  On the 10.5M-row slice (PERF.md; NVIDIA H100 80GB HBM3, 700 W) p=1
takes 0.303 ms against a 0.262 ms bound and cuSPARSE's 0.467, p=8 0.784 ms
against 0.438.  Staging the band in shared memory, which fits one f32
column there, was measured slower (0.319 ms at p=1) and is not used.

f32 states accumulate in f32, as the Pallas kernel does; f64 states in
f64 (the Pallas kernel casts f64 planes to f32 and sums in f32).

On a CUDA tensor `windowed_spmm` launches windowed_spmm_kernel of
`csrc/lanczos_kernels.cu` and counts each launch in `build.LAUNCHES`; on a
CPU tensor it runs `windowed_spmm_plain`.
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops.kernels import build

LANES = 128
SPMM_COLS = 8  # kSpmmCols of the .cu: columns per launch, wider states loop


def plane_columns(A) -> torch.Tensor:
    """(C_pad, ppc, 128) int64 column of every plane slot of A: the group's
    window base plus the plane's offset in 128-blocks plus the local
    index."""
    C = A.planes_data.shape[0] // A.ppc
    dev = A.planes_data.device
    group = torch.arange(C, device=dev) // (A.cpb * A.spg)
    base = A.wb.long()[group]
    return (base[:, None, None]
            + A.planes_off.long().view(C, A.ppc, 1) * LANES
            + A.planes_lidx.long().view(C, A.ppc, LANES))


def windowed_spmm_plain(A, X: torch.Tensor) -> torch.Tensor:
    """Plain torch version: gather X at every plane slot's column, multiply
    by the plane values, sum over each chunk's planes."""
    C, p = A.planes_data.shape[0] // A.ppc, X.shape[0]
    gathered = X.index_select(1, plane_columns(A).reshape(-1))
    prod = gathered.view(p, C, A.ppc, LANES) * A.planes_data.view(1, C, A.ppc, LANES)
    return prod.sum(dim=2).reshape(p, C * LANES)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def windowed_spmm(A, X: torch.Tensor, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Y = A X for a packed state X (p, n128), p >= 1, into `out` (a new
    buffer if None, else a (p, n128) tensor that must not overlap X: other
    rows still gather from X).  A is a `WindowedEllMatrix`."""
    if X.ndim != 2 or X.shape[1] != A.n128:
        raise ValueError(
            f"padded state must be (p, {A.n128}), got {tuple(X.shape)}; "
            "use .pack()"
        )
    if out is None:
        out = torch.empty_like(X)
    elif out.shape != X.shape:
        raise ValueError(f"out must be {tuple(X.shape)}, got {tuple(out.shape)}")
    if _overlap(out, X):
        raise ValueError("windowed_spmm: out must not alias x (rows still "
                         "gather from it)")
    if X.dtype != A.dtype:
        raise TypeError(f"windowed_spmm: state {X.dtype}, planes {A.dtype}")
    if X.device.type == "cpu":
        return out.copy_(windowed_spmm_plain(A, X))
    build.require_cuda("windowed_spmm", X, out, A.planes_data)
    for t in (A.planes_lidx, A.planes_off, A.wb):
        if t.device != X.device or not t.is_contiguous():
            raise ValueError("windowed_spmm: plane arrays must be contiguous "
                             f"on {X.device}")
    # the kernel reads a lane's four values as 16 bytes and its four
    # indices as one 4-byte word (always so for the plan's own buffers)
    if A.planes_data.data_ptr() % 16 or A.planes_lidx.data_ptr() % 4:
        raise ValueError("windowed_spmm: plane arrays must be 16-byte "
                         "(values) and 4-byte (indices) aligned")
    p = X.shape[0]
    build.launch(
        "windowed_spmm", X, "lt_windowed_spmm", build.dtype_code(X),
        A.planes_data.data_ptr(), A.planes_lidx.data_ptr(),
        A.planes_off.data_ptr(), A.wb.data_ptr(), X.data_ptr(), out.data_ptr(),
        p, A.ppc, A.cpb * A.spg, A.n128, build.stream_handle(X),
        count=-(-p // SPMM_COLS),  # a launch a group of SPMM_COLS columns
    )
    return out
