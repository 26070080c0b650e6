"""K1 and K6: separable stencils on the folded-plane state.

Ports of `apply_stencil_pair` (K1) and `apply_stencil` (K6) of
lanczos_tpu/ops/pallas/stencil_kernel.py (:70 and :276).  Each block column
of the state is a stack of fields in the *folded-plane* layout (n, Zc, P):
z is the row axis and the (y, x) plane is folded into the lane axis, padded
to a multiple of 128.  In this layout an x-shift by +-1 is a lane roll by
-+1, a y-shift by +-1 a lane roll by -+xc, and a z-shift a one-row shift,
so every tap is a shifted read times two separable weights:

    out[oc, z, l] += wz[t, z] * wplane[t, l] * u[ic, z + dz, l - r]

K6, `apply_stencil`, is the generic form: n_in fields in, n_out out, each
tap with its own two weights, taps summed in spec order as (v * wp) * wz.
K1, `apply_stencil_pair`, is the Maxwell curl pair on (6, Zc, P): half h
writes components 3h..3h+2 from the opposite half's three, and with
`spec.paired` each adjacent tap pair shares one weight row, so a pair
costs three multiplies.  A pair with an unpaired half is two K6 launches,
one per half, reading and writing component slices of the same tensors.

A z-row outside [0, Zc) reads as 0 in both versions below.  The Pallas
kernels read a clamped neighbour block there instead: the two agree
wherever the z-weights of rows 0 and Zc-1 are zero, which every operator
constructor guarantees.  Lane rolls wrap circularly, as `jnp.roll` does.

On a CUDA tensor the wrappers launch the hand-written kernels
(`csrc/lanczos_kernels.cu`, stencil_pair_kernel and apply_stencil_kernel);
on a CPU tensor they run the plain versions, the same arithmetic in torch
ops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from lanczos_tpu_torch.ops.kernels import build

MAX_TAPS_PER_COMP = 4  # csrc kMaxTaps
MAX_COMPS = 6  # csrc kGenComps: K6's components in and out
MAX_GENERIC_TAPS = 27  # csrc kGenTaps: K6's taps per output component


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static stencil description.

    taps: tuple of (out_comp, in_comp, dz, roll) — dz in {-1,0,1} is the
    z-row offset; roll is the lane-roll amount within the folded plane
    (already reduced mod P; 0 for pure z-taps).  For the pair stencil the
    components are local to a half (0..2).
    """

    n_in: int
    n_out: int
    taps: tuple[tuple[int, int, int, int], ...]
    zc: int  # z capacity
    plane: int  # folded-plane capacity P (multiple of 128)
    # paired=True asserts taps come in adjacent 2-tuples per curl block
    # sharing (out, in) with EQUAL shared separable factors: a z-pair
    # (dz differs) shares its wplane row, a plane-pair (roll differs)
    # shares its wz row — enabling the factored 3-multiply form (K1, K4,
    # K5).  An unpaired pair stencil runs as two K6 launches.
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


def require_paired(spec_a: StencilSpec, spec_b: StencilSpec, name: str) -> None:
    """K1's tap table, K4 and K5 take the factored (paired) form only."""
    if not (spec_a.paired and spec_b.paired):
        raise ValueError(f"{name} takes paired specs only")


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


# -- K6: the generic stencil ------------------------------------------------


def check_spec(spec: StencilSpec, dtype: torch.dtype) -> None:
    """What K6 takes, on every device: f32/f64 states, <= MAX_COMPS
    components in and out, every output component fed by 1 ..
    MAX_GENERIC_TAPS taps, in-range components and dz in {-1, 0, 1}."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"apply_stencil takes float32 or float64, got {dtype}")
    if not (1 <= spec.n_in <= MAX_COMPS and 1 <= spec.n_out <= MAX_COMPS):
        raise ValueError(
            f"apply_stencil takes 1..{MAX_COMPS} components in and out, got "
            f"{spec.n_in} -> {spec.n_out}"
        )
    for oc, ic, dz, _ in spec.taps:
        if not (0 <= oc < spec.n_out and 0 <= ic < spec.n_in and dz in (-1, 0, 1)):
            raise ValueError(f"tap {(oc, ic, dz)} out of range for {spec}")
    for oc in range(spec.n_out):
        n = len(_comp_taps(spec, oc))
        if not 1 <= n <= MAX_GENERIC_TAPS:
            raise ValueError(
                f"output component {oc} has {n} taps; apply_stencil takes "
                f"1..{MAX_GENERIC_TAPS} per component"
            )


def apply_stencil_plain(u, wz, wplane, spec: StencilSpec) -> torch.Tensor:
    """Plain torch version of K6: u (p, n_in, Zc, P) -> (p, n_out, Zc, P);
    wz (n_taps, Zc), wplane (n_taps, P).  Taps summed in spec order, each
    term (v * wp) * wz, as the Pallas kernel."""
    check_spec(spec, u.dtype)
    out = u.new_empty((u.shape[0], spec.n_out, spec.zc, spec.plane))
    for oc in range(spec.n_out):
        acc = None
        for t in _comp_taps(spec, oc):
            _, ic, dz, r = spec.taps[t]
            term = _tap_input(u, ic, dz, r) * wplane[t]
            term = term * wz[t][:, None]
            acc = term if acc is None else acc + term
        out[:, oc] = acc
    return out


def generic_tap_table(spec: StencilSpec):
    """K6's tap table (csrc GenericTaps) as a ctypes int array: n_out, then
    per output component 0..MAX_COMPS-1: n, t[27], ic[27], dz[27], r[27],
    taps in spec order, r reduced to [0, P)."""
    vals = [spec.n_out]
    for oc in range(MAX_COMPS):
        idx = _comp_taps(spec, oc) if oc < spec.n_out else []
        pad = [0] * (MAX_GENERIC_TAPS - len(idx))
        taps = [spec.taps[t] for t in idx]
        vals.append(len(idx))
        vals += idx + pad
        vals += [tp[1] for tp in taps] + pad
        vals += [tp[2] for tp in taps] + pad
        vals += [tp[3] % spec.plane for tp in taps] + pad
    return (ctypes.c_int * len(vals))(*vals)


def _field_strides_ok(x: torch.Tensor, spec: StencilSpec) -> bool:
    """(p, n, Zc, P) whose last three axes are contiguous (a component
    slice of a contiguous state qualifies); p may be strided."""
    return x.stride()[1:] == (spec.zc * spec.plane, spec.plane, 1)


def stencil_into(u, out, wz, wplane, spec: StencilSpec) -> torch.Tensor:
    """out[...] = K6(u): u (p, n_in, Zc, P) and out (p, n_out, Zc, P) may
    be component slices of larger states (their (component, z, lane) axes
    contiguous, the block axis strided); wz (n_taps, Zc) may be strided,
    e.g. the transpose of a pair's wz_t[h].  On the card out must not
    share u's buffer.  Returns out."""
    check_spec(spec, u.dtype)
    p = u.shape[0]
    if tuple(u.shape) != (p, spec.n_in, spec.zc, spec.plane) or tuple(
        out.shape
    ) != (p, spec.n_out, spec.zc, spec.plane):
        raise ValueError(
            f"u/out must be (p, {spec.n_in}/{spec.n_out}, {spec.zc}, "
            f"{spec.plane}), got {tuple(u.shape)}/{tuple(out.shape)}"
        )
    nt = len(spec.taps)
    if tuple(wz.shape) != (nt, spec.zc) or tuple(wplane.shape) != (nt, spec.plane):
        raise ValueError(
            f"weights must be wz ({nt}, {spec.zc}) and wplane ({nt}, "
            f"{spec.plane}), got {tuple(wz.shape)}/{tuple(wplane.shape)}"
        )
    if u.device.type == "cpu":
        return out.copy_(apply_stencil_plain(u, wz, wplane, spec))
    build.require_cuda("apply_stencil", wplane)
    for name, x in (("u", u), ("out", out), ("wz", wz)):
        if x.device != wplane.device or x.dtype != wplane.dtype:
            raise ValueError(
                f"apply_stencil: {name} must be {wplane.dtype} on {wplane.device}")
    if not (_field_strides_ok(u, spec) and _field_strides_ok(out, spec)):
        raise ValueError("apply_stencil: u/out need contiguous (n, Zc, P) fields")
    if u.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
        raise ValueError("apply_stencil: out must not share u's buffer")
    if max(spec.n_in, spec.n_out) * spec.zc * spec.plane > 2**30:
        raise ValueError("one block column must hold <= 2^30 elements")
    err = build.library().lt_apply_stencil(
        build.dtype_code(u), u.data_ptr(), out.data_ptr(), wz.data_ptr(),
        wplane.data_ptr(), generic_tap_table(spec), p, spec.zc, spec.plane,
        u.stride(0), out.stride(0), wz.stride(0), wz.stride(1),
        build.grid_blocks(spec.zc * spec.plane), build.stream_handle(u),
    )
    build.LAUNCHES["apply_stencil"] += 1
    build.check(err, "apply_stencil")
    return out


def apply_stencil(
    u: torch.Tensor,
    wz: torch.Tensor,
    wplane: torch.Tensor,
    spec: StencilSpec,
) -> torch.Tensor:
    """u: (n_in, Zc, P), or (p, n_in, Zc, P) with a leading block axis (what
    `jax.vmap(apply_stencil)` takes); wz: (n_taps, Zc); wplane: (n_taps,
    P).  Returns (n_out, Zc, P), or (p, n_out, Zc, P), in u's dtype.  CPU
    tensors take the plain version; CUDA tensors the kernel."""
    single = u.ndim == 3
    if single:
        u = u[None]
    out = u.new_empty((u.shape[0], spec.n_out, spec.zc, spec.plane))
    stencil_into(u, out, wz, wplane, spec)
    return out[0] if single else out


# -- K1: the Maxwell curl pair ----------------------------------------------


def apply_stencil_pair_plain(
    u: torch.Tensor,
    wz_t: torch.Tensor,
    wplane: torch.Tensor,
    spec_a: StencilSpec,
    spec_b: StencilSpec,
) -> torch.Tensor:
    """Plain torch version of the pair: u (p, 6, Zc, P) -> A u, same
    shape.  A paired half takes the Pallas kernel's factored form, an
    unpaired one K6's plain version on the component slices."""
    _check_pair(spec_a, spec_b)
    out = torch.empty_like(u)
    for h, spec in enumerate((spec_a, spec_b)):
        base = 3 * (1 - h)  # half h reads the OPPOSITE half's components
        wz = wz_t[h]  # (Zc, n_taps)
        wp = wplane[h]  # (n_taps, P)
        if not spec.paired:
            out[:, 3 * h : 3 * h + 3] = apply_stencil_plain(
                u[:, base : base + 3], wz.T, wp, spec)
            continue
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
    """The paired kernels' tap table (csrc StencilTaps) as a ctypes int
    array: per output component 0..5, n, t[4], ic[4], dz[4], r[4], with ic
    the global input component and r reduced to [0, P)."""
    _check_pair(spec_a, spec_b)
    require_paired(spec_a, spec_b, "the paired stencil kernels (K1, K4, K5)")
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
    version; CUDA tensors K1 when both halves are paired, else two K6
    launches (a paired half then sums its taps unfactored, which differs
    from the factored form in rounding only)."""
    if u.device.type == "cpu":
        return apply_stencil_pair_plain(u, wz_t, wplane, spec_a, spec_b)
    _check_pair(spec_a, spec_b)
    build.require_cuda("apply_stencil_pair", u, wz_t, wplane)
    nt = check_geometry(u, wz_t, wplane, spec_a)
    out = torch.empty_like(u)
    if not (spec_a.paired and spec_b.paired):
        for h, spec in enumerate((spec_a, spec_b)):
            base = 3 * (1 - h)
            stencil_into(u[:, base : base + 3], out[:, 3 * h : 3 * h + 3],
                         wz_t[h].T, wplane[h], spec)
        return out
    taps = tap_table(spec_a, spec_b)
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
