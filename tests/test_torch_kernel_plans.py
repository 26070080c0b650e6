"""The launch choices of K2 (block_mix) and of K1 on bf16 states: pure host
functions of the call, checked on the CPU.

K2's: `block_dense.mix_fixed` (the compiled-in (K, p_out) or the runtime-K
kernel), `mix_vector_width` (16-byte or scalar loads) and `mix_blocks` (the
grid).  K1 bf16's: `stencil_kernel.curl_taps`, whether the tap table has
the Maxwell curl's structure, which it reads two lanes a load, and how it
loads each tap.  The kernels themselves run
on the card (tests/test_torch_kernels.py, `-m cuda`).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from lanczos_tpu_torch.ops.kernels import block_dense
from lanczos_tpu_torch.ops.kernels.stencil_kernel import curl_taps

S160 = 6 * 176 * 26624  # one block column of the N=160 Maxwell state


@pytest.mark.parametrize("K,p_out,fixed", [
    (12, 4, True), (8, 4, True), (4, 4, True),   # the mono step, the peeled steps
    (3, 1, True), (2, 1, True), (1, 1, True),    # the vector route
    (12, 3, False), (6, 2, False), (24, 8, False), (16, 4, False),
    (4, 1, False), (1, 4, False), (54, 18, False), (5, 17, False),
])
def test_mix_fixed_takes_the_paths_shapes_only(K, p_out, fixed):
    assert block_dense.mix_fixed(K, p_out) is fixed


def test_mix_shapes_are_the_fused_recurrence_calls():
    """p=4: (3p, p) in the mono and 3-call steps, (2p, p) and (p, p) in the
    peeled steps; p=1: the same at one column."""
    want = {(k * p, p) for p in (1, 4) for k in (3, 2, 1)}
    assert set(block_dense.MIX_SHAPES) == want


# (S, itemsize, pointer offsets of the operands then out, rows of each, V)
@pytest.mark.parametrize("S,itemsize,offsets,rows,vec", [
    (S160, 4, (0, 0, 0, 0), (4, 4, 4, 4), 4),     # f32 p=4: float4 words
    (S160, 8, (0, 0, 0, 0), (4, 4, 4, 4), 1),     # f64: one 8-byte load
    (S160, 2, (0, 0, 0, 0), (1, 1, 1, 1), 8),     # bf16 p=1: eight a word
    (S160, 2, (0, 0, 0, 0), (4, 4, 4, 4), 8),
    (1001, 4, (0, 0, 0, 0), (1, 1, 1, 1), 4),     # one row each: a tail of 1
    (1001, 2, (0, 0), (1, 1), 8),                 # a tail of 1001 % 8 = 1
    (1001, 4, (0, 0, 0), (2, 1, 1), 1),           # row 1 of x0 misaligned
    (1001, 4, (0, 0), (1, 2), 1),                 # row 1 of out misaligned
    (1000, 4, (0, 4, 0, 0), (1, 1, 1, 1), 1),     # one operand off by an f32
    (1000, 4, (0, 16, 0, 0), (4, 4, 4, 4), 4),    # off by a whole 16 bytes
    (1000, 8, (0, 0, 8), (2, 2, 2), 1),           # out off by an f64
    (1000, 2, (2, 0), (4, 4), 1),                 # bf16 off by one element
    (1024, 4, (0, 0), (8, 8), 4),                 # p_out = 8: still 16 bytes
    (1024, 4, (0, 0), (9, 9), 1),                 # p_out = 9: V x p_out too many
    (1024, 4, (0, 0, 0), (5, 5, 17), 1),
])
def test_mix_vector_width_follows_size_alignment_and_p_out(S, itemsize, offsets,
                                                           rows, vec):
    ptrs = [4096 * (i + 1) + o for i, o in enumerate(offsets)]
    assert block_dense.mix_vector_width(S, itemsize, ptrs, rows) == vec


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.float64, 1),
                                       (torch.bfloat16, 8)])
def test_mix_vector_width_of_views(dtype, vec):
    """What the wrapper passes for real tensors: a view at a storage offset
    that breaks 16-byte alignment takes the scalar instantiation, a split of
    a buffer whose rows are whole 16-byte words does not."""
    def width(xs, out):
        return block_dense.mix_vector_width(
            xs[0][0].numel(), out.element_size(),
            [x.data_ptr() for x in (*xs, out)],
            [x.shape[0] for x in xs] + [out.shape[0]])

    stack = torch.zeros((3, 4, 1024), dtype=dtype)
    out = torch.zeros((4, 1024), dtype=dtype)
    assert width(stack.unbind(0), out) == vec
    flat = torch.zeros(1 + 4 * 1024, dtype=dtype)
    shifted = flat[1:].view(4, 1024)  # storage offset 1 element
    assert shifted.is_contiguous() and shifted.storage_offset() == 1
    assert width((shifted,), out) == 1
    assert width((stack[0],), shifted) == 1
    whole = flat[16 // shifted.element_size():][: 2 * 1024].view(2, 1024)
    assert width((whole,), out[:2]) == vec


@pytest.mark.parametrize("S,vec,sms,blocks", [
    (1, 4, 132, 1),
    (1024, 4, 132, 1),             # one vector a thread: 256 vectors a block
    (1025, 4, 132, 2),
    (256 * 4 * 100, 4, 132, 100),
    (S160, 4, 132, 264),           # N=160: the cap, two blocks on each SM
    (S160, 8, 132, 264),
    (S160, 1, 114, 228),           # another card's SMs
    (S160 // 8, 8, 132, 264),
])
def test_mix_blocks_from_the_sm_count(S, vec, sms, blocks):
    assert block_dense.mix_blocks(S, vec, 2 * sms) == blocks


@functools.lru_cache(maxsize=None)
def _specs(n):
    from lanczos_tpu_torch.models.maxwell_pallas import _host_taps

    return _host_taps(n, n, n, np.float32)[0]


@pytest.mark.parametrize("n", [3, 4, 6, 160])
def test_curl_taps_of_the_maxwell_operator(n):
    """Every Maxwell geometry has the curl's tap structure, so K1 on a bf16
    state reads two lanes a load.  The roll-0 taps take one 32-bit load;
    each plane-pair's rolled tap takes two, joined by a byte permute where
    its roll is odd: the x-pair's +-1 lane always, the y-pair's xc = n + 3
    lanes (6, 7, 9, 163) where xc is odd."""
    spec_a, spec_b = _specs(n)
    xc = n + 3
    loads = curl_taps(spec_a, spec_b)
    assert loads is not None and len(loads) == 6
    y = 2 if xc % 2 else 1
    # components 0, 1 of a half: z-pair, then a plane-pair rolled in y (0) or
    # x (1); component 2: a y-pair, then an x-pair (E half: 0 y, 1 x, 2 both)
    assert loads[:3] == ((0, 0, 0, y), (0, 0, 0, 2), (0, y, 0, 2))
    assert loads[3:] == loads[:3]
    for h, spec in enumerate((spec_a, spec_b)):
        for oc in range(3):
            taps = [tp for tp in spec.taps if tp[0] == oc]
            for (_, _, dz, r), load in zip(taps, loads[3 * h + oc]):
                shift = min(r % spec.plane, spec.plane - r % spec.plane)
                assert shift in (0, 1, xc)
                assert load == (0 if shift == 0 else 1 + shift % 2)
                assert not (dz and load)


def test_curl_taps_refuse_other_tap_tables():
    """A tap table without the curl's structure is read a lane a thread:
    an unpaired half, a z-pair in the other order, a roll on a tap the curl
    reads with one load."""
    import dataclasses

    spec_a, spec_b = _specs(6)
    assert curl_taps(spec_a, spec_b) is not None
    assert curl_taps(dataclasses.replace(spec_a, paired=False), spec_b) is None
    taps = list(spec_a.taps)
    taps[0], taps[1] = taps[1], taps[0]  # the z-pair's rows z+1, z
    assert curl_taps(dataclasses.replace(spec_a, taps=tuple(taps)), spec_b) is None
    taps = list(spec_b.taps)
    taps[2] = taps[2][:3] + (1,)  # the plane-pair's first tap rolled
    assert curl_taps(spec_a, dataclasses.replace(spec_b, taps=tuple(taps))) is None
