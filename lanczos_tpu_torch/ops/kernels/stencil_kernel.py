"""K1: the Maxwell curl-pair stencil on the folded-plane state.

Port of `apply_stencil_pair` (lanczos_tpu/ops/pallas/stencil_kernel.py:70).
Each block column of the state is a stack of six fields in the
*folded-plane* layout (6, Zc, P): z is the row axis and the (y, x) plane is
folded into the lane axis, padded to a multiple of 128.  In this layout an
x-shift by +-1 is a lane roll by -+1, a y-shift by +-1 a lane roll by
-+xc, and a z-shift a one-row shift, so every tap is a shifted read times
two separable weights:

    out[3h + oc, z, l] += wz_t[h, z, t] * wplane[h, t, l] * u[ic, z + dz, l - r]

Half h writes components 3h..3h+2 from the opposite half's three.  The
weights are zero wherever a lane roll wraps or a z-shift leaves the state,
so both versions below read 0 there (the Pallas kernel clamps instead;
the weights make the two agree).

On a CUDA tensor `apply_stencil_pair` launches the hand-written kernel
(`csrc/lanczos_kernels.cu`, stencil_pair_kernel); on a CPU tensor it runs
`apply_stencil_pair_plain`, the same arithmetic in torch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from lanczos_tpu_torch.ops.kernels import build

MAX_TAPS_PER_COMP = 4  # csrc kMaxTaps


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static stencil description.

    taps: tuple of (out_comp, in_comp, dz, roll) — dz in {-1,0,1} is the
    z-row offset; roll is the lane-roll amount within the folded plane
    (already reduced mod P; 0 for pure z-taps).  Components are local to a
    half (0..2).
    """

    n_in: int
    n_out: int
    taps: tuple[tuple[int, int, int, int], ...]
    zc: int  # z capacity
    plane: int  # folded-plane capacity P (multiple of 128)
    # paired=True asserts taps come in adjacent 2-tuples per curl block
    # sharing (out, in) with EQUAL shared separable factors: a z-pair
    # (dz differs) shares its wplane row, a plane-pair (roll differs)
    # shares its wz row — enabling the factored 3-multiply form.  The
    # port's pair stencil takes paired specs only (the Maxwell operator's).
    paired: bool = False


def _comp_taps(spec: StencilSpec, oc: int) -> list[int]:
    return [t for t, tp in enumerate(spec.taps) if tp[0] == oc]


def _check_pair(spec_a: StencilSpec, spec_b: StencilSpec) -> None:
    if (spec_b.zc, spec_b.plane) != (spec_a.zc, spec_a.plane):
        raise ValueError("halves must share zc/plane geometry")
    if len(spec_b.taps) != len(spec_a.taps):
        raise ValueError("halves must have equal tap counts")
    if (spec_a.n_in, spec_a.n_out, spec_b.n_in, spec_b.n_out) != (3, 3, 3, 3):
        raise ValueError("pair kernel is specialized to 3-in/3-out halves")
    if not (spec_a.paired and spec_b.paired):
        raise ValueError("the pair stencil takes paired specs only")


def _tap_input(u: torch.Tensor, ic: int, dz: int, r: int) -> torch.Tensor:
    """(p, Zc, P) input of one tap: component ic shifted by dz rows (0
    past either end) and rolled by r lanes (jnp.roll semantics)."""
    v = u[:, ic]
    if dz == 1:
        v = F.pad(v[:, 1:], (0, 0, 0, 1))
    elif dz == -1:
        v = F.pad(v[:, :-1], (0, 0, 1, 0))
    if r:
        v = torch.roll(v, r, dims=-1)
    return v


def apply_stencil_pair_plain(
    u: torch.Tensor,
    wz_t: torch.Tensor,
    wplane: torch.Tensor,
    spec_a: StencilSpec,
    spec_b: StencilSpec,
) -> torch.Tensor:
    """Plain torch version of the kernel: u (p, 6, Zc, P) -> A u, same
    shape.  Same tap order and paired factoring as the Pallas kernel."""
    _check_pair(spec_a, spec_b)
    out = torch.empty_like(u)
    for h, spec in enumerate((spec_a, spec_b)):
        base = 3 * (1 - h)  # half h reads the OPPOSITE half's components
        wz = wz_t[h]  # (Zc, n_taps)
        wp = wplane[h]  # (n_taps, P)
        for oc in range(3):
            idx = _comp_taps(spec, oc)
            acc = None
            for k in range(0, len(idx), 2):
                t0, t1 = idx[k], idx[k + 1]
                (_, ic0, dz0, r0) = spec.taps[t0]
                (_, ic1, dz1, r1) = spec.taps[t1]
                v0 = _tap_input(u, base + ic0, dz0, r0)
                v1 = _tap_input(u, base + ic1, dz1, r1)
                if dz0 != dz1:  # z-pair: shared wplane row
                    s = v0 * wz[:, t0, None] + v1 * wz[:, t1, None]
                    term = s * wp[t0]
                else:  # plane-pair: shared wz row
                    s = v0 * wp[t0] + v1 * wp[t1]
                    term = s * wz[:, t0, None]
                acc = term if acc is None else acc + term
            out[:, 3 * h + oc] = acc
    return out


def tap_table(spec_a: StencilSpec, spec_b: StencilSpec):
    """The kernels' tap table (csrc StencilTaps) as a ctypes int array: per
    output component 0..5, n, t[4], ic[4], dz[4], r[4], with ic the global
    input component and r reduced to [0, P)."""
    _check_pair(spec_a, spec_b)
    vals = []
    for h, spec in enumerate((spec_a, spec_b)):
        for oc in range(3):
            idx = _comp_taps(spec, oc)
            if len(idx) > MAX_TAPS_PER_COMP or len(idx) % 2:
                raise ValueError(
                    f"CUDA stencil takes an even count <= {MAX_TAPS_PER_COMP} "
                    f"of taps per output component, got {len(idx)}"
                )
            pad = [0] * (MAX_TAPS_PER_COMP - len(idx))
            taps = [spec.taps[t] for t in idx]
            vals.append(len(idx))
            vals += idx + pad
            vals += [3 * (1 - h) + tp[1] for tp in taps] + pad
            vals += [tp[2] for tp in taps] + pad
            vals += [tp[3] % spec.plane for tp in taps] + pad
    return (ctypes.c_int * len(vals))(*vals)


def check_geometry(u: torch.Tensor, wz_t, wplane, spec: StencilSpec) -> int:
    """Shape checks shared by K1 and K4; returns the taps per half."""
    if u.ndim != 4 or tuple(u.shape[1:]) != (6, spec.zc, spec.plane):
        raise ValueError(
            f"state must be (p, 6, {spec.zc}, {spec.plane}), got {tuple(u.shape)}"
        )
    nt = wz_t.shape[-1]
    if tuple(wz_t.shape) != (2, spec.zc, nt) or tuple(wplane.shape) != (
        2, nt, spec.plane
    ):
        raise ValueError("weights must be wz_t (2, Zc, T) and wplane (2, T, P)")
    if 6 * spec.zc * spec.plane > 2**30:  # the kernels index it in int32
        raise ValueError("one block column must hold <= 2^30 elements")
    return nt


def apply_stencil_pair(
    u: torch.Tensor,
    wz_t: torch.Tensor,
    wplane: torch.Tensor,
    spec_a: StencilSpec,
    spec_b: StencilSpec,
) -> torch.Tensor:
    """A u for the Maxwell curl pair.  u: (p, 6, Zc, P) block-major;
    wz_t: (2, Zc, n_taps) z-weights stacked per half; wplane: (2, n_taps,
    P).  Returns a new tensor shaped like u.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if u.device.type == "cpu":
        return apply_stencil_pair_plain(u, wz_t, wplane, spec_a, spec_b)
    build.require_cuda("apply_stencil_pair", u, wz_t, wplane)
    nt = check_geometry(u, wz_t, wplane, spec_a)
    taps = tap_table(spec_a, spec_b)
    out = torch.empty_like(u)
    lib = build.library()
    positions = spec_a.zc * spec_a.plane  # one thread per (z, l)
    err = lib.lt_stencil_pair(
        build.dtype_code(u), u.data_ptr(), out.data_ptr(),
        wz_t.data_ptr(), wplane.data_ptr(), taps, u.shape[0],
        spec_a.zc, spec_a.plane, nt, build.grid_blocks(positions),
        build.stream_handle(u),
    )
    build.LAUNCHES["apply_stencil_pair"] += 1
    build.check(err, "apply_stencil_pair")
    return out
