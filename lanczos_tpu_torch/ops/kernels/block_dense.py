"""K2, K3 and K7: the block-dense algebra around the operator.

Ports of `block_mix`, `block_grams` and `block_grams_compensated`
(lanczos_tpu/ops/pallas/block_dense.py:104, :210 and :361).  All are
memory-bound passes over block operands (p_i, *state) that read every
operand once:

* ``block_mix(coeffs, xs)``  — out[j] = sum_k coeffs[k, j] * cat(xs)[k]
  (the reference's tall x small ``mm_ts`` update, `mm_ts.hpp:110`);
* ``block_grams(xs, z)``     — gram(cat(xs), z)[k, j] = <cat(xs)[k], z[j]>
  over all state axes (the reference's ``mm_tt``/``mm_tt2``), f32
  accumulation, with ``include_zz`` appending gram(z, z) from the same read
  of z;
* ``block_grams_compensated(xs, z)`` — the same Gram of f32 operands with
  O(eps_f32) error instead of O(eps_f32 sqrt(n)).  The JAX kernel stands in
  for f64, which the TPU lacks, with Dekker TwoProd/TwoSum chains; on the
  H100 an f32 x f32 product is exact in f64, so the kernel accumulates in
  f64 and rounds the total to f32 once.

bf16 states (the bf16 folded-plane operator's, JAX's `dtype=bfloat16`):
K2 takes f32 coefficients, sums in f32 and rounds once to bf16 on store;
K3 returns an f32 Gram; K7 widens bf16 to f32 (exact) and returns f32, as
JAX's K7 upcasts them.  The accumulation type is `acc_dtype`: f32, or the
state's own if wider.

On CUDA tensors they launch block_mix_kernel and gram_kernel (K3, and K7
with f64 sums) of `csrc/lanczos_kernels.cu`; on CPU tensors they run the
plain versions.  The Gram launch is set by pure functions of the call:
`gram_tile` (the register tile, from (K, p)), `gram_vector_width` (16-byte
or scalar loads, from S and the operands' alignment) and `gram_blocks`
(the grid, from S and the card's cap, `build.gram_grid_cap`).
"""

from __future__ import annotations

import torch

from lanczos_tpu_torch.ops import precision  # noqa: F401  (full-f32 matmuls)
from lanczos_tpu_torch.ops.kernels import build
from lanczos_tpu_torch.ops.kernels.build import acc_dtype

MAX_P_OUT = 32  # csrc block_mix instantiations
MAX_OPERANDS = 3


def block_mix_plain(coeffs: torch.Tensor, xs, inplace: bool = False):
    """Plain torch version of `block_mix` (same contract)."""
    xs = tuple(xs)
    acc = acc_dtype(xs[0].dtype)
    cat = torch.cat([x.reshape(x.shape[0], -1) for x in xs]).to(acc)
    out = (coeffs.to(acc).T @ cat).to(xs[0].dtype)
    out = out.reshape((coeffs.shape[1],) + tuple(xs[0].shape[1:]))
    if inplace:
        return xs[0].copy_(out)
    return out


def _mix_checks(coeffs, xs, inplace):
    ps = [x.shape[0] for x in xs]
    if not 1 <= len(xs) <= MAX_OPERANDS:
        raise ValueError(f"block_mix takes 1..{MAX_OPERANDS} operands")
    if coeffs.ndim != 2 or coeffs.shape[0] != sum(ps):
        raise ValueError(f"coeffs {tuple(coeffs.shape)} vs operand rows {ps}")
    state = xs[0].shape[1:]
    if any(x.shape[1:] != state or x.dtype != xs[0].dtype for x in xs):
        raise ValueError("operands must share state shape and dtype")
    p_out = coeffs.shape[1]
    if inplace and p_out != ps[0]:
        raise ValueError(
            f"inplace block_mix needs p_out == xs[0] rows ({p_out} != {ps[0]})"
        )
    return ps, p_out


def block_mix(coeffs: torch.Tensor, xs, inplace: bool = False) -> torch.Tensor:
    """out[j] = sum_k coeffs[k, j] * cat(xs, axis=0)[k].

    coeffs: (K, p_out) with K = sum of the leading dims of xs; xs: 1..3
    (p_i, *state) tensors sharing state shape and dtype.  inplace=True
    writes the result onto xs[0] (needs p_out == xs[0].shape[0]) and
    returns it; xs[0]'s old contents are gone."""
    xs = tuple(xs)
    ps, p_out = _mix_checks(coeffs, xs, inplace)
    if xs[0].device.type == "cpu":
        return block_mix_plain(coeffs, xs, inplace)
    build.require_cuda("block_mix", *xs, bf16=True)
    if p_out > MAX_P_OUT:
        raise ValueError(f"CUDA block_mix takes p_out <= {MAX_P_OUT}")
    # f32 and f64 states accumulate in their own type, bf16 ones in f32
    cf = coeffs.to(device=xs[0].device, dtype=acc_dtype(xs[0].dtype)).contiguous()
    out = xs[0] if inplace else torch.empty(
        (p_out,) + tuple(xs[0].shape[1:]), dtype=xs[0].dtype,
        device=xs[0].device,
    )
    ptrs = [x.data_ptr() for x in xs] + [None] * (MAX_OPERANDS - len(xs))
    rows = ps + [0] * (MAX_OPERANDS - len(xs))
    S = xs[0][0].numel()
    build.launch(
        "block_mix", out, "lt_block_mix", build.dtype_code(xs[0], True), ptrs[0],
        rows[0], ptrs[1], rows[1], ptrs[2], rows[2], cf.data_ptr(),
        out.data_ptr(), p_out, S, build.grid_blocks(S),
        build.stream_handle(out),
    )
    return out


def gram_plain(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """gram(x, z)[k, j] = <x[k], z[j]> over all state axes, accumulated
    in `acc_dtype`."""
    acc = acc_dtype(z.dtype)
    return x.reshape(x.shape[0], -1).to(acc) @ z.reshape(z.shape[0], -1).to(acc).T


def block_grams_plain(xs, z: torch.Tensor, include_zz: bool = False):
    """Plain torch version of `block_grams` (same contract)."""
    ops = list(xs) + ([z] if include_zz else [])
    return torch.cat([gram_plain(x, z) for x in ops])


def _gram_operands(name, xs, z, include_zz):
    xs = tuple(xs)
    if len(xs) > MAX_OPERANDS or (not xs and not include_zz):
        raise ValueError(f"{name} takes 1..{MAX_OPERANDS} row operands")
    if any(x.shape[1:] != z.shape[1:] or x.dtype != z.dtype for x in xs):
        raise ValueError("operands must share z's state shape and dtype")
    return xs


def gram_tile(K: int, p: int) -> tuple[int, int]:
    """The (R, C) register tile of gram_kernel for a (K, p) Gram: exact at
    the fused recurrence's calls (K = p or 2p at p = 1 and p = 4), so none
    of them carries a dead accumulator; the 12 x 4 tile for every other
    shape, repeated over the grid's y/z axes when K > 12 or p > 4.  Each
    exact tile beats 12 x 4 on its call (PERF.md, `probes --gram-tiles`)."""
    if p == 1 and K <= 2:
        return K, 1
    if p == 4 and K in (4, 8):
        return K, 4
    return 12, 4


def gram_vector_width(S: int, itemsize: int, ptrs) -> int:
    """Elements per load of gram_kernel: 16 bytes' worth (4 f32, 2 f64, 8 bf16)
    when every operand row starts on a 16-byte boundary (each operand's
    pointer is aligned and a row of S elements is a multiple of 16 bytes),
    else 1, the scalar instantiation."""
    if (S * itemsize) % 16 == 0 and all(ptr % 16 == 0 for ptr in ptrs):
        return 16 // itemsize
    return 1


def gram_blocks(S: int, max_blocks: int) -> int:
    """Blocks of gram_kernel's grid, a function of S on a given card (so
    the sums add in the same order on every run): one block per 1024
    elements (256 threads, 4 elements each), at most `max_blocks`."""
    return max(1, min(-(-S // 1024), max_blocks))


_tickets: dict = {}


def _ticket(z: torch.Tensor) -> torch.Tensor:
    """The word gram_kernel's blocks take their ticket from, one per
    (device, stream).  Zeroed here once, at the first launch on the
    stream; every launch's last block sets it back to 0, and launches on
    one stream run in order, so no call needs a memset of its own."""
    key = (z.device, build.stream_handle(z))
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=z.device)
    return _tickets[key]


def _gram_launch(name, entry, lead, xs, z, include_zz, acc, out_dtype):
    """Shared launch of the two Gram kernels through the C entry point
    `entry` (its leading arguments `lead`): the (K, p) result from
    per-block partial sums in `acc`, added in block order by the grid's
    last block."""
    build.require_cuda(name, z, *xs, bf16=True)
    p = z.shape[0]
    ops = list(xs) + ([z] if include_zz else [])
    ptrs = [x.data_ptr() for x in ops] + [None] * (4 - len(ops))
    rows = [x.shape[0] for x in ops] + [0] * (4 - len(ops))
    K = sum(rows)
    S = z[0].numel()
    tile_r, tile_c = gram_tile(K, p)
    vec = gram_vector_width(S, z.element_size(),
                            [x.data_ptr() for x in (*xs, z)])
    nblocks = gram_blocks(S, build.gram_grid_cap(z.device))
    partial = torch.empty((nblocks, K, p), dtype=acc, device=z.device)
    out = torch.empty((K, p), dtype=out_dtype, device=z.device)
    build.launch(
        name, z, entry, *lead, ptrs[0], rows[0], ptrs[1], rows[1], ptrs[2],
        rows[2], ptrs[3], rows[3], z.data_ptr(), p, S, tile_r, tile_c, vec,
        partial.data_ptr(), nblocks, _ticket(z).data_ptr(), out.data_ptr(),
        build.stream_handle(z),
    )
    return out


def block_grams(xs, z: torch.Tensor, include_zz: bool = False) -> torch.Tensor:
    """gram(cat(xs), z): (K, p) with K = sum p_i (+ p with include_zz,
    which appends gram(z, z) as the trailing p rows).  xs: 0..3 operands
    (p_i, *state) shaped like z; accumulates in f32 (f64 for f64 states),
    and returns that type (an f32 Gram of bf16 states).  The CUDA path
    sums across thread blocks in a fixed order, so the result repeats bit
    for bit from run to run."""
    xs = _gram_operands("block_grams", xs, z, include_zz)
    if z.device.type == "cpu":
        return block_grams_plain(xs, z, include_zz)
    acc = acc_dtype(z.dtype)
    return _gram_launch("block_grams", "lt_block_grams",
                        (build.dtype_code(z, True),), xs, z, include_zz, acc,
                        acc)


def block_grams_compensated_plain(xs, z: torch.Tensor, include_zz: bool = False):
    """Plain torch version of `block_grams_compensated`: the Gram in f64
    (bf16 and f32 widen exactly), rounded to f32 once."""
    ops = list(xs) + ([z] if include_zz else [])
    cat = torch.cat([x.reshape(x.shape[0], -1) for x in ops]).double()
    return (cat @ z.reshape(z.shape[0], -1).double().T).float()


def block_grams_compensated(xs, z: torch.Tensor,
                            include_zz: bool = False) -> torch.Tensor:
    """`block_grams` of f32 (or bf16) operands with O(eps_f32) error:
    every product is exact in f64 and the sums run in f64 (per thread, per
    block, then across blocks in block order), rounded to the (K, p) f32
    result once.  bf16 states widen to f32, as the JAX kernel upcasts
    them.  f64 states raise: they need no compensation (use
    `block_grams`), and the JAX kernel would silently cast them to f32."""
    xs = _gram_operands("block_grams_compensated", xs, z, include_zz)
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"block_grams_compensated takes float32 or bfloat16 states, got "
            f"{z.dtype}"
        )
    if z.device.type == "cpu":
        return block_grams_compensated_plain(xs, z, include_zz)
    return _gram_launch("block_grams_compensated",
                        "lt_block_grams_compensated", (build.dtype_code(z, True),),
                        xs, z, include_zz, torch.float64, torch.float32)
