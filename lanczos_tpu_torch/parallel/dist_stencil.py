"""The distributed Maxwell operator on z-slabs (port of
`lanczos_tpu/parallel/dist_stencil.py`).

The stacked folded-plane state (6, Z, P) is split along z over the ranks
of a 1-D mesh.  Each rank stores the slab ``[tz pad | zl interior | tz
pad]`` of Zs = zl + 2 tz rows, with zl = round_up(ceil((nz + 1) / n_dev),
tz), and the pads stay zero, so Grams and norms of slabs summed over the
ranks are the global ones with no masking.  The layout is JAX's row for
row: rank r's slab is rows [r Zs, (r + 1) Zs) of JAX's global state.
One product is

  1. the halo exchange, one z-plane (p, 6, P) to each neighbour
     (`Mesh.exchange`, JAX's `ppermute`s), zeros at the two ends;
  2. the received planes written into rows tz - 1 and Zs - tz of a work
     copy of the slab: the state itself keeps its zero pads;
  3. K1 (`apply_stencil_pair`, the hand-written CUDA kernel on the card)
     on the work copy with this rank's z-weights, which are zero outside
     the interior rows, so the product's pads are zero too.

The operator has `mesh`, so the Lanczos methods sum every reduction over
the ranks and refuse the fused recurrence, whose K4 Gram would be local.
It has `scaled` and no `fdtd_step`: the FDTD oracle steps u + (dt A) u as
K1 plus an add (JAX's branch), because K5's identity term on the
halo-filled work copy would write the halo planes into the pads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from lanczos_tpu_torch.models.maxwell import maxwell_component_shapes
from lanczos_tpu_torch.models.maxwell_pallas import Z_OFF, _host_taps, _np_dtype
from lanczos_tpu_torch.ops.kernels.stencil_kernel import (
    StencilSpec,
    apply_stencil_pair,
)
from lanczos_tpu_torch.ops.operator import LinearOperator
from lanczos_tpu_torch.parallel.mesh import Mesh

TZ = 8  # JAX's default: slab rows and indices match JAX's one for one


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def slab_rows(nz: int, n_dev: int, tz: int = TZ) -> tuple[int, int]:
    """(zl, Zs): interior rows a slab holds and its stored rows."""
    zl = _round_up(-(-(nz + 1) // n_dev), tz)
    return zl, zl + 2 * tz


def slab_weights(nx: int, ny: int, nz: int, n_dev: int, rank: int,
                 tz: int = TZ, dtype=np.float32):
    """Rank `rank`'s slab of the operator, as NumPy arrays: ((spec_e,
    spec_h), wz_t (2, Zs, T), wplane_s (2, T, P), zl).  Rows [tz, tz + zl)
    of wz_t hold the z-weights of global planes [rank zl, (rank + 1) zl);
    every other row is zero.  A pure function of its arguments, so one
    process can build every rank's slab (the tests, `chip_smoke.py`)."""
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} is not in a mesh of {n_dev}")
    if tz < 1:
        raise ValueError(f"tz must be >= 1, got {tz}")
    specs, wz_g, wplane_s = _host_taps(nx, ny, nz, np.dtype(dtype))
    zl, zs = slab_rows(nz, n_dev, tz)
    z_ext = nz + 1  # the largest component z extent
    full = np.zeros((2, n_dev * zl, wz_g.shape[-1]), wz_g.dtype)
    full[:, :z_ext] = wz_g[:, Z_OFF : Z_OFF + z_ext]
    wz_t = np.zeros((2, zs, wz_g.shape[-1]), wz_g.dtype)
    wz_t[:, tz : tz + zl] = full[:, rank * zl : (rank + 1) * zl]
    specs = tuple(dataclasses.replace(s, zc=zs) for s in specs)
    return specs, wz_t, wplane_s, zl


class DistributedPallasMaxwell(LinearOperator):
    """The Maxwell operator A on this rank's z-slab of a 1-D mesh.  States
    are this rank's slabs: (6, Zs, P), or (p, 6, Zs, P) block-major."""

    shard_axis = -2  # the slabs stack along z into JAX's global state

    def __init__(self, nx, ny, nz, wz_t: torch.Tensor, wplane_s: torch.Tensor,
                 specs: tuple[StencilSpec, StencilSpec], mesh: Mesh, zl: int,
                 tz: int):
        super().__init__()
        self.nx, self.ny, self.nz = nx, ny, nz
        self.register_buffer("wz_t", wz_t.contiguous())
        self.register_buffer("wplane_s", wplane_s.contiguous())
        self.spec_e, self.spec_h = specs
        self.mesh = mesh
        self.zl, self.tz = zl, tz
        self.comp_shapes = maxwell_component_shapes(nx, ny, nz)
        self.comp_sizes = tuple(int(np.prod(s)) for s in self.comp_shapes)
        self.n = int(sum(self.comp_sizes))
        self.xc, self.yc = nx + 3, ny + 3

    @classmethod
    def create(cls, nx: int, ny: int, nz: int, mesh: Mesh,
               dtype=torch.float32, tz: int = TZ) -> "DistributedPallasMaxwell":
        """This rank's operator, its weights on `mesh.device`; dtype
        float32 or float64."""
        specs, wz_t, wplane_s, zl = slab_weights(
            nx, ny, nz, mesh.size, mesh.rank, tz, _np_dtype(dtype))
        return cls(nx, ny, nz, torch.as_tensor(wz_t, device=mesh.device),
                   torch.as_tensor(wplane_s, device=mesh.device), specs, mesh,
                   zl, tz)

    # -- LinearOperator interface ------------------------------------------

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.wz_t.dtype

    @property
    def n_dev(self) -> int:
        return self.mesh.size

    @property
    def state_shape(self):
        """The shape of this rank's slab of one state (JAX's is the global
        (6, n_dev Zs, P), of which this is rows [rank Zs, (rank + 1) Zs))."""
        return (6, self.spec_e.zc, self.spec_e.plane)

    def mv(self, u: torch.Tensor) -> torch.Tensor:
        return self.mm(u[None])[0]

    def mm(self, U: torch.Tensor) -> torch.Tensor:
        """This rank's slab of A U: (p, 6, Zs, P) -> same (a collective)."""
        return apply_stencil_pair(self._with_halos(U), self.wz_t,
                                  self.wplane_s, self.spec_e, self.spec_h)

    def _with_halos(self, U: torch.Tensor) -> torch.Tensor:
        """U, or on more than one rank a copy of U with the neighbours'
        edge planes in rows tz - 1 and Zs - tz.  On one rank those rows are
        U's own zero pads already."""
        if self.mesh.size == 1:
            return U
        tz, zs = self.tz, self.spec_e.zc
        from_left, from_right = self.mesh.exchange(U[:, :, tz],
                                                   U[:, :, zs - tz - 1])
        work = U.clone()
        work[:, :, tz - 1] = from_left
        work[:, :, zs - tz] = from_right
        return work

    def scaled(self, s) -> "DistributedPallasMaxwell":
        """The operator computing (s A) u: s folded into the z-weights
        (the FDTD dt); shares the plane weights and the mesh."""
        s = torch.as_tensor(s, dtype=self.wz_t.dtype, device=self.wz_t.device)
        return type(self)(self.nx, self.ny, self.nz, self.wz_t * s,
                          self.wplane_s, (self.spec_e, self.spec_h), self.mesh,
                          self.zl, self.tz)

    # -- state packing ------------------------------------------------------

    def pack(self, b) -> torch.Tensor:
        """Global flat logical vector(s) -> this rank's slab on its device:
        (n,) -> (6, Zs, P), block-major (p, n) -> (p, 6, Zs, P).  Only the
        slab's planes are moved to the device."""
        b = torch.as_tensor(b).to(self.dtype)
        single = b.ndim == 1
        if single:
            b = b[None]
        zs, tz, zl, plane = self.spec_e.zc, self.tz, self.zl, self.spec_e.plane
        lo = self.mesh.rank * zl
        planes, o = [], 0
        for (zc, yl, xl), sz in zip(self.comp_shapes, self.comp_sizes):
            comp = b[:, o : o + sz].reshape(-1, zc, yl, xl)[:, lo : lo + zl]
            o += sz
            k = comp.shape[1]
            comp = F.pad(comp, (1, self.xc - 1 - xl, 1, self.yc - 1 - yl,
                                tz, zs - tz - k))
            comp = comp.reshape(-1, zs, self.yc * self.xc)
            planes.append(F.pad(comp, (0, plane - self.yc * self.xc)))
        out = torch.stack(planes, dim=1).to(self.mesh.device)
        return out[0] if single else out

    def unpack(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's slab(s) -> the global flat logical vector(s), on
        every rank (an all-gather of the slabs: a collective)."""
        return self.unpack_slabs(self.mesh.all_gather(u))

    def unpack_slabs(self, slabs: torch.Tensor) -> torch.Tensor:
        """Every rank's slab, stacked in rank order ((n_dev, 6, Zs, P) or
        (n_dev, p, 6, Zs, P)) -> the flat logical vector(s); no collective."""
        single = slabs.ndim == 4
        if single:
            slabs = slabs[:, None]
        nd, p = slabs.shape[:2]
        tz, zl = self.tz, self.zl
        inner = slabs[..., tz : tz + zl, : self.yc * self.xc]
        g = inner.permute(1, 2, 0, 3, 4).reshape(p, 6, nd * zl, self.yc, self.xc)
        out = torch.cat([
            g[:, c, :zc, 1 : 1 + yl, 1 : 1 + xl].reshape(p, -1)
            for c, (zc, yl, xl) in enumerate(self.comp_shapes)
        ], dim=1)
        return out[0] if single else out

    def state_index(self, lc: int) -> tuple[int, int, int]:
        """Global storage coordinates (comp, z, plane_pos) of the logical
        flat index lc: z counts the rows of JAX's global state, so rank
        z // Zs holds it, at row z % Zs."""
        lc = int(lc)
        for c, (shape, sz) in enumerate(zip(self.comp_shapes, self.comp_sizes)):
            if lc < sz:
                _, yl, xl = shape
                z, r = divmod(lc, yl * xl)
                y, x = divmod(r, xl)
                s, zloc = divmod(z, self.zl)
                return (c, s * self.spec_e.zc + self.tz + zloc,
                        (1 + y) * self.xc + (1 + x))
            lc -= sz
        raise IndexError("lc out of range")

    def trace_fn(self, lc: int):
        """Receiver extractor for the Lanczos methods: the value at logical
        index lc on the rank that holds it, zero on every other rank.  The
        Lanczos methods sum the stacked trace over the ranks once, at the end."""
        return self._owner_trace(*self.state_index(lc))

    def storage_trace_fn(self, i: int):
        """The same at flat index i of JAX's global stacked state (6, n_dev
        Zs, P): the Lanczos methods' receiver when given lc and no trace_fn."""
        c, z, ps = np.unravel_index(
            int(i), (6, self.n_dev * self.spec_e.zc, self.spec_e.plane))
        return self._owner_trace(int(c), int(z), int(ps))

    def _owner_trace(self, c: int, z: int, ps: int):
        owner, row = divmod(z, self.spec_e.zc)
        if owner == self.mesh.rank:
            return lambda q: q[..., c, row, ps].clone()
        return lambda q: q.new_zeros(q.shape[:-3])
