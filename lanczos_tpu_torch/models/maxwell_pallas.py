"""The Maxwell operator on the stacked folded-plane state (the port's
counterpart of `lanczos_tpu/models/maxwell_pallas.py`).

The state is not a flat (n,) vector but one stacked tensor (6, Zc, P) per
block column: six field components, z as the row axis, and the (y, x)
plane folded into the lane axis (P a multiple of 128).  Component
interiors sit at offset (z=Z_OFF, y=1, x=1) inside zero pads.  The layout
is bit-identical to the JAX package's, so states compare elementwise:
Z_OFF = 8, Zc = round_up(Z_OFF + nz + 2, TZ) and P = round_up((ny+3)(nx+3),
128).  A @ u is the curl-pair stencil (`ops/kernels/stencil_kernel.py`,
K1), the fused iteration's A @ q + Grams pass is K4
(`ops/kernels/stencil_gram.py`), and the FDTD step u + (dt A) u is K5
(`ops/kernels/stencil_fdtd.py`).

A bf16 state (`create(..., dtype=torch.bfloat16)`, JAX's `dtype=bfloat16`)
halves the state's bytes: the weights stay f32, and K1 promotes each bf16
input to them, sums in f32 and rounds once on store.  `dtype` is then the
state's bf16, apart from the weights'.  As in JAX, only K1 reads bf16
planes: neither the fused pass (K4) nor the one-pass FDTD step (K5) takes
them, so the fused recurrence runs its 3-call step and FDTD steps K1 then
an add (`supports_stencil_gram` and `supports_fdtd_inplace` are false).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lanczos_tpu_torch.models.maxwell import _build_taps, maxwell_component_shapes
from lanczos_tpu_torch.ops.kernels import stencil_fdtd, stencil_gram
from lanczos_tpu_torch.ops.kernels.build import acc_dtype
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    StencilSpec,
    apply_stencil_pair,
)
from lanczos_tpu_torch.ops.operator import LinearOperator, target_device

Z_OFF = 8  # z-storage row of the first interior plane
TZ = 16  # Zc is a multiple of TZ, the JAX default, so the layouts match


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _host_taps(nx: int, ny: int, nz: int, np_dtype):
    """The (spec_e, spec_h) stencil specs and the (wz_t, wplane_s) weight
    stacks as NumPy arrays — the JAX `create`'s host work, verbatim."""
    descs, arrays = _build_taps(nx, ny, nz, np.float64)
    shapes = maxwell_component_shapes(nx, ny, nz)
    xc, yc = nx + 3, ny + 3
    plane = _round_up(yc * xc, 128)
    z_ext_max = nz + 1
    # interior at z-row Z_OFF with >= 1 zero-weight row before/after
    zc = _round_up(Z_OFF + z_ext_max + 1, TZ)

    halves = {"e": {"wz": [], "wp": [], "taps": []},
              "h": {"wz": [], "wp": [], "taps": []}}
    for (out_c, in_c, ax, off), (wz_l, wy_l, wx_l) in zip(descs, arrays):
        zlen, ylen, xlen = shapes[out_c]
        row_z = np.zeros(zc, np_dtype)
        row_z[Z_OFF : Z_OFF + zlen] = wz_l
        wp = np.zeros((yc, xc))
        wp[1 : 1 + ylen, 1 : 1 + xlen] = np.outer(wy_l, wx_l)
        row_p = np.zeros(plane, np_dtype)
        row_p[: yc * xc] = wp.reshape(-1)
        if ax == 0:
            dz, roll = off, 0
        elif ax == 1:
            dz, roll = 0, (-off * xc) % plane
        else:
            dz, roll = 0, (-off) % plane
        half = halves["e"] if out_c < 3 else halves["h"]
        oc_local = out_c if out_c < 3 else out_c - 3
        ic_local = in_c - 3 if out_c < 3 else in_c  # E reads H, H reads E
        half["wz"].append(row_z)
        half["wp"].append(row_p)
        half["taps"].append((oc_local, ic_local, dz, roll))

    # invariant behind `paired=True`: the two taps of each curl
    # block share their non-difference separable factors exactly
    for k in ("e", "h"):
        tl, wzl, wpl = halves[k]["taps"], halves[k]["wz"], halves[k]["wp"]
        for i in range(0, len(tl), 2):
            assert tl[i][:2] == tl[i + 1][:2], "taps not block-paired"
            if tl[i][2] != tl[i + 1][2]:  # z-pair: shared plane row
                assert np.array_equal(wpl[i], wpl[i + 1])
            else:  # plane-pair: shared z row
                assert np.array_equal(wzl[i], wzl[i + 1])
    specs = tuple(
        StencilSpec(n_in=3, n_out=3, taps=tuple(halves[k]["taps"]),
                    zc=zc, plane=plane, paired=True)
        for k in ("e", "h")
    )
    wz_t = np.stack([np.stack(halves[k]["wz"]).T for k in ("e", "h")])
    wplane_s = np.stack([np.stack(halves[k]["wp"]) for k in ("e", "h")])
    return specs, wz_t, wplane_s


class PallasMaxwellOperator(LinearOperator):
    """A = D @ diag(w) as the curl-pair stencil on stacked fields.  The
    weights wz_t (2, Zc, n_taps) and wplane_s (2, n_taps, P), stacked per
    half (E rows, H rows), are registered buffers; `state_dtype` is the
    states' type (the weights', or bf16 with f32 weights)."""

    def __init__(self, nx, ny, nz, wz_t: torch.Tensor, wplane_s: torch.Tensor,
                 specs: tuple[StencilSpec, StencilSpec],
                 state_dtype: torch.dtype | None = None):
        super().__init__()
        self.nx, self.ny, self.nz = nx, ny, nz
        self.state_dtype = wz_t.dtype if state_dtype is None else state_dtype
        if acc_dtype(self.state_dtype) != wz_t.dtype:
            raise TypeError(f"{self.state_dtype} states take "
                            f"{acc_dtype(self.state_dtype)} weights, got "
                            f"{wz_t.dtype}")
        # the kernels take contiguous weights
        self.register_buffer("wz_t", wz_t.contiguous())
        self.register_buffer("wplane_s", wplane_s.contiguous())
        self.spec_e, self.spec_h = specs
        self.spec = specs[0]  # geometry reference (zc/plane shared)
        self.comp_shapes = maxwell_component_shapes(nx, ny, nz)
        self.comp_sizes = tuple(int(np.prod(s)) for s in self.comp_shapes)
        self.n = int(sum(self.comp_sizes))
        self.xc = nx + 3
        self.yc = ny + 3

    @classmethod
    def create(cls, nx: int, ny: int, nz: int, dtype=torch.float32,
               device="cuda") -> "PallasMaxwellOperator":
        """dtype: the states' float32, float64 or bfloat16; a bf16 state
        keeps f32 weights, as JAX's does (`lanczos_tpu/models/
        maxwell_pallas.py:60-76`)."""
        device = target_device(device)
        state = _state_dtype(dtype)
        specs, wz_t, wplane_s = _host_taps(nx, ny, nz, _np_dtype(acc_dtype(state)))
        return cls(
            nx, ny, nz,
            torch.as_tensor(wz_t, device=device),
            torch.as_tensor(wplane_s, device=device),
            specs, state,
        )

    @classmethod
    def from_arrays(cls, nx: int, ny: int, nz: int, wz_t, wplane_s, *,
                    device="cuda", dtype=torch.float32
                    ) -> "PallasMaxwellOperator":
        """The operator from weight arrays made elsewhere (e.g. the JAX
        operator's ``np.asarray(op.wz_t)``, ``np.asarray(op.wplane_s)``);
        the tap metadata is rebuilt from the geometry.  dtype is the
        states' type: a bf16 operator's weights come in as f32 (a JAX bf16
        operator's are)."""
        device = target_device(device)
        state = _state_dtype(dtype)
        specs, wz_ref, wp_ref = _host_taps(nx, ny, nz, np.float64)
        wz_t, wplane_s = np.asarray(wz_t), np.asarray(wplane_s)
        if wz_t.shape != wz_ref.shape or wplane_s.shape != wp_ref.shape:
            raise ValueError(
                f"weights {wz_t.shape}/{wplane_s.shape} do not fit the "
                f"{nx}x{ny}x{nz} geometry {wz_ref.shape}/{wp_ref.shape}"
            )
        return cls(
            nx, ny, nz,
            torch.tensor(wz_t, dtype=acc_dtype(state), device=device),
            torch.tensor(wplane_s, dtype=acc_dtype(state), device=device),
            specs, state,
        )

    # -- LinearOperator interface ------------------------------------------

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        """The states' type (not the weights' on a bf16 operator)."""
        return self.state_dtype

    @property
    def state_shape(self):
        return (6, self.spec.zc, self.spec.plane)

    def mv(self, u: torch.Tensor) -> torch.Tensor:
        return self.mm(u[None])[0]

    def mm(self, U: torch.Tensor) -> torch.Tensor:
        """Block-major (p, 6, Zc, P) -> A U (K1)."""
        return apply_stencil_pair(U, self.wz_t, self.wplane_s, self.spec_e,
                                  self.spec_h)

    # -- fused Lanczos-iteration support ------------------------------------

    def supports_stencil_gram(self, p: int, dtype=None) -> bool:
        return stencil_gram.supports(p, self.dtype if dtype is None else dtype)

    def supports_fdtd_inplace(self, p: int, dtype=None) -> bool:
        """Whether `fdtd_step` (K5) takes p block columns of this dtype:
        f32 and f64 at every p, no bf16 (JAX's `plan_fdtd_inplace`)."""
        return stencil_fdtd.supports(p, self.dtype if dtype is None else dtype)

    def fdtd_step(self, u: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """out = u + A u in one pass (K5) and returns out, which must be
        another buffer than u.  Call it on an operator whose weights fold
        dt (`.scaled(dt)`).  u, out: (6, Zc, P) or (p, 6, Zc, P)."""
        single = u.ndim == 3
        if single:
            u, out = u[None], out[None]
        out = stencil_fdtd.fdtd_step(u, out, self.wz_t, self.wplane_s,
                                     self.spec_e, self.spec_h)
        return out[0] if single else out

    def stencil_gram(self, q: torch.Tensor, dst: torch.Tensor):
        """(v, g3) = (A q, [gram(q,v); gram(v,v); gram(dst,q)]) in one pass
        (K4), with v written into dst's buffer.  dst's old contents are
        gone afterwards."""
        return stencil_gram.apply_stencil_pair_gram(
            q, dst, self.wz_t, self.wplane_s, self.spec_e, self.spec_h
        )

    def scaled(self, s) -> "PallasMaxwellOperator":
        """Operator computing (s*A) @ u: folds a scalar prefactor (FDTD dt)
        into the z-weights, so no separate scaling pass over the state is
        spent.  Shares the plane weights."""
        s = torch.as_tensor(s, dtype=self.wz_t.dtype, device=self.wz_t.device)
        return type(self)(self.nx, self.ny, self.nz, self.wz_t * s,
                          self.wplane_s, (self.spec_e, self.spec_h),
                          self.state_dtype)

    # -- state packing ------------------------------------------------------

    def pack(self, b: torch.Tensor) -> torch.Tensor:
        """Flat logical vector(s) -> stacked state.  b: (n,) -> (6, Zc, P);
        block-major (p, n) -> (p, 6, Zc, P).  Keeps b's device."""
        b = torch.as_tensor(b).to(self.dtype)
        single = b.ndim == 1
        if single:
            b = b[None]
        spec = self.spec
        planes = []
        o = 0
        for (zl, yl, xl), sz in zip(self.comp_shapes, self.comp_sizes):
            comp = b[:, o : o + sz].reshape(-1, zl, yl, xl)
            o += sz
            comp = F.pad(comp, (1, self.xc - 1 - xl, 1, self.yc - 1 - yl,
                                Z_OFF, spec.zc - Z_OFF - zl))
            comp = comp.reshape(-1, spec.zc, self.yc * self.xc)
            comp = F.pad(comp, (0, spec.plane - self.yc * self.xc))
            planes.append(comp)
        out = torch.stack(planes, dim=1)
        return out[0] if single else out

    def unpack(self, u: torch.Tensor) -> torch.Tensor:
        """Stacked state -> flat logical vector(s)."""
        single = u.ndim == 3
        if single:
            u = u[None]
        parts = []
        for c, (zl, yl, xl) in enumerate(self.comp_shapes):
            comp = u[:, c, :, : self.yc * self.xc].reshape(
                -1, self.spec.zc, self.yc, self.xc
            )
            parts.append(
                comp[:, Z_OFF : Z_OFF + zl, 1 : 1 + yl, 1 : 1 + xl].reshape(
                    u.shape[0], -1
                )
            )
        out = torch.cat(parts, dim=1)
        return out[0] if single else out

    def state_index(self, lc: int) -> tuple[int, int, int]:
        """Stacked-state coordinates (comp, z_storage, plane_pos) of the
        logical flat index lc — feed to `trace_fn`."""
        lc = int(lc)
        for c, (shape, sz) in enumerate(zip(self.comp_shapes, self.comp_sizes)):
            if lc < sz:
                zl, yl, xl = shape
                z, r = divmod(lc, yl * xl)
                y, x = divmod(r, xl)
                return (c, Z_OFF + z, (1 + y) * self.xc + (1 + x))
            lc -= sz
        raise IndexError("lc out of range")

    def trace_fn(self, lc: int):
        """Receiver extractor for the Lanczos methods: a copy of
        q[..., c, zs, ps] (a copy, because the fused recurrence later
        overwrites q's buffer)."""
        c, zs, ps = self.state_index(lc)
        return lambda q: q[..., c, zs, ps].clone()


def _np_dtype(dtype) -> np.dtype:
    """The weights' NumPy type: float32 or float64."""
    if dtype in (torch.float32, np.float32, "float32"):
        return np.dtype(np.float32)
    if dtype in (torch.float64, np.float64, "float64"):
        return np.dtype(np.float64)
    raise ValueError(f"the Maxwell weights are float32 or float64, got {dtype}")


def _state_dtype(dtype) -> torch.dtype:
    """The states' torch type, from a torch dtype, a NumPy type or a name:
    float32, float64 or bfloat16."""
    if dtype in (torch.float32, np.float32, "float32"):
        return torch.float32
    if dtype in (torch.float64, np.float64, "float64"):
        return torch.float64
    if dtype in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    raise ValueError(
        f"PallasMaxwellOperator takes float32, float64 or bfloat16 states, "
        f"got {dtype}")
