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

K1's kernel (shared with K5, `stencil_fdtd.py`) gives a block a strip of
lanes over a range of z-rows and stages the input rows, with a halo of
lanes on either side, in shared memory.  `stencil_plan` picks the strip
width, the z-range and the shared-memory bytes from the geometry and the
halo that `stencil_halos` reads off the taps' rolls; `tap_table` and the
plan are cached per spec pair, so a loop of launches (the FDTD oracle's
10^6 steps) rebuilds neither.

A z-row outside [0, Zc) reads as 0 in both versions below.  The Pallas
kernels read a clamped neighbour block there instead: the two agree
wherever the z-weights of rows 0 and Zc-1 are zero, which every operator
constructor guarantees.  Lane rolls wrap circularly, as `jnp.roll` does.

On a CUDA tensor the wrappers launch the hand-written kernels
(`csrc/lanczos_kernels.cu`, stencil_pair_kernel and apply_stencil_kernel);
on a CPU tensor they run the plain versions, the same arithmetic in torch
ops.  Every launch goes through `build.launch`, on the tensor's device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from lanczos_tpu_torch.ops.kernels import build

MAX_TAPS_PER_COMP = 4  # csrc kMaxTaps
MAX_COMPS = 6  # csrc kGenComps: K6's components in and out
MAX_GENERIC_TAPS = 27  # csrc kGenTaps: K6's taps per output component
# K1/K5's strips (csrc strip_stencil_body)
STENCIL_THREADS = 256  # csrc kThreads: threads a block
STENCIL_SLOTS = 6  # csrc kStencilSlots: staged rows (z-1..z+1, two ahead, one behind)
STENCIL_ROW_WEIGHTS = 6 * MAX_TAPS_PER_COMP  # csrc kRowWeights: a row's z-weights
STENCIL_STAGE_COPIES = 8  # csrc kStageCopies: 16-byte copies a thread a row
# lanes a block owns, by itemsize: two a thread in f32, one in f64 (the
# f32 pick is `probes --stencil-tiles`'s, PERF.md)
STENCIL_WIDTH = {4: 512, 8: 256}
# csrc StripTraits::kMinBlocks, by (itemsize, lanes a thread): the blocks an
# SM holds by registers (__launch_bounds__); csrc instantiates these
STENCIL_MIN_BLOCKS = {(4, 1): 4, (4, 2): 2, (8, 1): 2, (8, 2): 2}
SM_THREADS = 2048  # resident threads an SM (Hopper)
SM_SHARED_BYTES = 233_472  # shared memory an SM (228 KB)
BLOCK_SHARED_BYTES = 232_448  # the most one block may opt in to (227 KB)
BLOCK_SHARED_RESERVED = 1024  # the runtime's own shared memory a block


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
    # K5).  An unpaired half sums its taps one at a time: on the card K5
    # takes it in its own kernel, K1 as two K6 launches, K4 as K3 and K6
    # launches.
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
    build.launch(
        "apply_stencil", u, "lt_apply_stencil", build.dtype_code(u),
        u.data_ptr(), out.data_ptr(), wz.data_ptr(), wplane.data_ptr(),
        generic_tap_table(spec), p, spec.zc, spec.plane, u.stride(0),
        out.stride(0), wz.stride(0), wz.stride(1),
        build.grid_blocks(spec.zc * spec.plane), build.stream_handle(u),
    )
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


@functools.lru_cache(maxsize=64)
def tap_table(spec_a: StencilSpec, spec_b: StencilSpec):
    """The pair kernels' tap table (csrc StencilTaps) as a ctypes int
    array: per output component 0..5, n, t[4], ic[4], dz[4], r[4], with ic
    the global input component and r reduced to [0, P); then each half's
    paired flag.  A paired half takes an even count of taps a component,
    an unpaired one 1..4.  Cached per spec pair; the kernels only read
    it."""
    _check_pair(spec_a, spec_b)
    vals = []
    for h, spec in enumerate((spec_a, spec_b)):
        for oc in range(3):
            idx = _comp_taps(spec, oc)
            if len(idx) > MAX_TAPS_PER_COMP or (spec.paired and len(idx) % 2):
                raise ValueError(
                    f"CUDA stencil takes <= {MAX_TAPS_PER_COMP} taps per output "
                    f"component, an even count when paired; got {len(idx)}"
                )
            taps = [spec.taps[t] for t in idx]
            if any(not (0 <= tp[1] < 3 and tp[2] in (-1, 0, 1)) for tp in taps):
                raise ValueError(f"tap out of range in {taps}")
            pad = [0] * (MAX_TAPS_PER_COMP - len(idx))
            vals.append(len(idx))
            vals += idx + pad
            vals += [3 * (1 - h) + tp[1] for tp in taps] + pad
            vals += [tp[2] for tp in taps] + pad
            vals += [tp[3] % spec.plane for tp in taps] + pad
    vals += [int(spec_a.paired), int(spec_b.paired)]
    return (ctypes.c_int * len(vals))(*vals)


def _signed_roll(r: int, plane: int) -> int:
    """A roll by r lanes reads lane l - s: s, in (-P/2, P/2], is r mod P
    taken as the shorter way round."""
    r %= plane
    return r if r <= plane // 2 else r - plane


def stencil_halos(spec_a: StencilSpec, spec_b: StencilSpec):
    """(left, right): the lanes each input component 0..5 (global; half h
    reads the opposite half's) must be staged beyond a strip on either
    side, so that every tap's roll reads inside the staged row."""
    left, right = [0] * 6, [0] * 6
    for h, spec in enumerate((spec_a, spec_b)):
        for _, ic, _, r in spec.taps:
            c = 3 * (1 - h) + ic
            s = _signed_roll(r, spec.plane)
            left[c], right[c] = max(left[c], s), max(right[c], -s)
    return tuple(left), tuple(right)


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """A K1/K5 launch: blocks of STENCIL_THREADS threads own `width` lanes
    (`lanes_per_thread` a thread, 256 apart) by `zchunk` z-rows, on a grid
    of strips x chunks, with STENCIL_SLOTS staged rows of `row` elements
    (each component's strip plus its left/right halo, rounded to 16
    bytes) and two rows' STENCIL_ROW_WEIGHTS z-weights in `smem_bytes` of
    shared memory."""

    width: int
    lanes_per_thread: int
    zchunk: int
    strips: int
    chunks: int
    smem_bytes: int
    left: tuple[int, ...]
    right: tuple[int, ...]
    row: int

    @functools.cached_property
    def ints(self):
        """The plan as the csrc launcher reads it (strip_args), a ctypes int
        array made once."""
        vals = [self.width, self.lanes_per_thread, self.zchunk, self.strips,
                self.chunks, self.smem_bytes, *self.left, *self.right]
        return (ctypes.c_int * len(vals))(*vals)


def _waves_cost(strips: int, k: int, zc: int, slots: int) -> int:
    """Row steps of the slowest block over the grid's waves: k z-chunks of
    ceil(zc / k) rows, each staging two more."""
    return -(-strips * k // slots) * (-(-zc // k) + 2)


def stencil_plan(zc: int, plane: int, halo_left, halo_right, p: int,
                 itemsize: int, sms: int, *, width: int | None = None,
                 zchunk: int | None = None) -> StencilPlan:
    """K1/K5's launch for a (p, 6, zc, plane) state of `itemsize`-byte
    elements on a card of `sms` SMs; halo_left/right per input component
    (`stencil_halos`).  The strip is STENCIL_WIDTH lanes, one or two on
    each of the block's threads (a plane narrower than the strip is staged
    wrapped, and only its own lanes are stored), the halos are rounded up
    to 16 bytes, and the z-chunk is the one whose grid of strips x chunks
    finishes soonest in whole waves (`_waves_cost`, fewer chunks on a
    tie), given the blocks an SM holds by threads, shared memory and
    registers.  `width` and
    `zchunk` override the pick (`probes --stencil-tiles`).  A pure
    function of its arguments; the block columns loop inside a block, so
    p only has to be >= 1."""
    if p < 1 or itemsize not in (4, 8):
        raise ValueError(f"stencil_plan takes p >= 1 and 4- or 8-byte "
                         f"elements, got p={p}, itemsize={itemsize}")
    vec = 16 // itemsize  # elements of a 16-byte copy
    if plane % vec:
        raise ValueError(f"plane {plane} is no multiple of 16 bytes")
    width = STENCIL_WIDTH[itemsize] if width is None else width
    lpt = width // STENCIL_THREADS
    if width != lpt * STENCIL_THREADS or (itemsize, lpt) not in STENCIL_MIN_BLOCKS:
        raise ValueError(f"no K1/K5 strip of {width} lanes")
    left = tuple(-(-h // vec) * vec for h in halo_left)
    right = tuple(-(-h // vec) * vec for h in halo_right)
    row = sum(width + a + b for a, b in zip(left, right))
    smem = (STENCIL_SLOTS * row + 2 * STENCIL_ROW_WEIGHTS) * itemsize
    copies = STENCIL_STAGE_COPIES * STENCIL_THREADS * vec  # elements a row
    if smem > BLOCK_SHARED_BYTES or row > copies:
        raise ValueError(f"K1/K5 staging needs {smem} bytes of shared memory "
                         f"a block (at most {BLOCK_SHARED_BYTES}) and rows of "
                         f"{row} elements (at most {copies})")
    strips = -(-plane // width)
    if zchunk is None:
        resident = min(SM_THREADS // STENCIL_THREADS,
                       SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED),
                       STENCIL_MIN_BLOCKS[itemsize, lpt])
        slots = resident * sms
        k = min(range(1, zc + 1), key=lambda k: (_waves_cost(strips, k, zc, slots), k))
        zchunk = -(-zc // k)
    return StencilPlan(width, lpt, zchunk, strips, -(-zc // zchunk), smem,
                       left, right, row)


@functools.lru_cache(maxsize=64)
def pair_plan(spec_a: StencilSpec, spec_b: StencilSpec, p: int, itemsize: int,
              sms: int) -> StencilPlan:
    """`stencil_plan` for the pair's geometry and halos, cached."""
    left, right = stencil_halos(spec_a, spec_b)
    return stencil_plan(spec_a.zc, spec_a.plane, left, right, p, itemsize, sms)


def launch_pair(name: str, entry: str, u, out, wz_t, wplane, spec_a, spec_b,
                nt: int) -> None:
    """K1 or K5 (`entry`) from u into out, both (p, 6, Zc, P) on the card:
    the cached tap table and plan, 16-byte staging copies."""
    if u.data_ptr() % 16:
        raise ValueError(f"{name}: u must start on a 16-byte boundary")
    p = u.shape[0]
    plan = pair_plan(spec_a, spec_b, p, u.element_size(), build.sm_count(u.device))
    build.launch(
        name, u, entry, build.dtype_code(u), u.data_ptr(), out.data_ptr(),
        wz_t.data_ptr(), wplane.data_ptr(), tap_table(spec_a, spec_b),
        plan.ints, p, spec_a.zc, spec_a.plane, nt, build.stream_handle(u),
    )


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
    launch_pair("apply_stencil_pair", "lt_stencil_pair", u, out, wz_t, wplane,
                spec_a, spec_b, nt)
    return out
