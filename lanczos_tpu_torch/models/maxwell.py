"""3-D staggered-grid ("Lee/Yee grid") Maxwell semi-discretization: host side.

NumPy copy of the tap construction and the scipy oracle of
`lanczos_tpu/models/maxwell.py` (the JAX package's `models/__init__`
imports jax, so the port cannot import them from there).  The operator is
``A = D @ diag(w)`` with ``D = [[0, Dh], [De, 0]]`` the curl pair over the
six staggered field components ``u = [E; H]`` and ``w`` the diagonal energy
weights (reference `source/matrix_a/build_A_ell.hpp:10`).  Every block of
``A`` is ``sign * kron(F3, F2, F1)`` with one bidiagonal 1-D factor and two
diagonal ones, so ``A @ u`` is a separable stencil.

`MaxwellOperator` (`--operator stencil`, the CLI's default) applies A to
the flat (n,) state in plain torch: each input component is padded once and
every tap is a shifted slice of it, as in the JAX package, which also runs
this operator outside any Pallas kernel.  `maxwell_ell_operator`
(`--operator ell`) is the assembled A as gathered ELL, also plain torch;
the folded-plane operator in `maxwell_pallas.py` is the one the stencil
CUDA kernels serve.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lanczos_tpu_torch.ops.operator import LinearOperator, target_device

# Component order: E1, E2, E3, H1, H2, H3 (matches reference state layout
# [E; H] produced by the `insert` calls in build_A_ell.hpp:190-212).
_E1, _E2, _E3, _H1, _H2, _H3 = range(6)


def _grids(nx: int, ny: int, nz: int, dtype=np.float64):
    """Primal/dual grid spacings (build_A_ell.hpp:22-45)."""

    def axis(n):
        npl = n + 2
        h = 1.0 / (npl - 1)
        xp = np.linspace(0.0, 1.0, npl, dtype=dtype)
        xd = np.linspace(0.0, 1.0 - h, npl - 1, dtype=dtype) + h / 2
        return np.diff(xp), np.diff(xd)  # (n+1,), (n,)

    dxp, dxd = axis(nx)
    dyp, dyd = axis(ny)
    dzp, dzd = axis(nz)
    return (dxp, dxd), (dyp, dyd), (dzp, dzd)


def maxwell_component_shapes(nx: int, ny: int, nz: int):
    """(z, y, x) shape of each of the six field components."""
    return (
        (nz, ny, nx + 1),      # E1
        (nz, ny + 1, nx),      # E2
        (nz + 1, ny, nx),      # E3
        (nz + 1, ny + 1, nx),  # H1
        (nz + 1, ny, nx + 1),  # H2
        (nz, ny + 1, nx + 1),  # H3
    )


def _component_weights(nx, ny, nz, dtype=np.float64):
    """Per-component separable energy weights (wz, wy, wx) with the H-field
    minus sign (build_A_ell.hpp:214-250, Wh.mult_scalar(-1) at :245) folded
    into the block signs by the caller."""
    (dxp, dxd), (dyp, dyd), (dzp, dzd) = _grids(nx, ny, nz, dtype)
    return [
        (dzd, dyd, dxp),  # E1
        (dzd, dyp, dxd),  # E2
        (dzp, dyd, dxd),  # E3
        (dzp, dyp, dxd),  # H1 (times -1)
        (dzp, dyd, dxp),  # H2 (times -1)
        (dzd, dyp, dxp),  # H3 (times -1)
    ]


# Each curl block of A: (out_comp, in_comp, sign, axis, kind)
#   axis: 0 = z, 1 = y, 2 = x — which 1-D factor is the bidiagonal
#   kind: "bwd" = X-type (out n+1, in n; taps at local offsets {0, -1},
#          values +-1/delta_p), "fwd" = X_hat-type (out n, in n+1; taps at
#          {0, +1}, values -+1/delta_d).  build_A_ell.hpp:85-97.
# The sign already includes the extra -1 for H-field column weights.
_BLOCKS = (
    # E rows  (Dh * (-wh)); Dh signs from build_A_ell.hpp:153-168
    (_E1, _H2, -1.0, 0, "fwd"),  # -Z_hat
    (_E1, _H3, +1.0, 1, "fwd"),  # +Y_hat
    (_E2, _H1, +1.0, 0, "fwd"),  # +Z_hat
    (_E2, _H3, -1.0, 2, "fwd"),  # -X_hat
    (_E3, _H1, -1.0, 1, "fwd"),  # -Y_hat
    (_E3, _H2, +1.0, 2, "fwd"),  # +X_hat
    # H rows  (De * we); De signs from build_A_ell.hpp:134-149
    (_H1, _E2, -1.0, 0, "bwd"),  # -Z
    (_H1, _E3, +1.0, 1, "bwd"),  # +Y
    (_H2, _E1, +1.0, 0, "bwd"),  # +Z
    (_H2, _E3, -1.0, 2, "bwd"),  # -X
    (_H3, _E1, -1.0, 1, "bwd"),  # -Y
    (_H3, _E2, +1.0, 2, "bwd"),  # +X
)


def _bidiag_taps(kind: str, delta_p: np.ndarray, delta_d: np.ndarray):
    """Taps (offset, coeff[out_len]) of the 1-D difference factor.

    "bwd": X = diag(1/delta_p) @ bidiag(n).T, shape (n+1, n):
        X[i, i]   = +1/delta_p[i]   (i < n)
        X[i, i-1] = -1/delta_p[i]   (i >= 1)
    "fwd": X_hat = -diag(1/delta_d) @ bidiag(n), shape (n, n+1):
        X_hat[i, i]   = -1/delta_d[i]
        X_hat[i, i+1] = +1/delta_d[i]
    (bidiag per build_ell_utils.hpp:123-138.)
    """
    if kind == "bwd":
        n = delta_d.shape[0]  # in-size
        out = n + 1
        c0 = np.zeros(out, delta_p.dtype)
        c0[:n] = 1.0 / delta_p[:n]
        cm = np.zeros(out, delta_p.dtype)
        cm[1:] = -1.0 / delta_p[1:]
        return ((0, c0), (-1, cm))
    else:
        n = delta_d.shape[0]  # out-size
        c0 = -1.0 / delta_d
        cp = 1.0 / delta_d
        return ((0, c0), (+1, cp))


def _build_taps(nx, ny, nz, dtype=np.float64):
    """Flatten the 12 blocks into 24 stencil taps.

    A tap is (out_comp, in_comp, axis, offset) static metadata plus three
    1-D weight arrays (wz, wy, wx) of the *output* component's axis sizes;
    the column weight of the input component is folded in:
    coeff_bidiag[i] *= w_in_axis[i + offset].
    """
    axes = _grids(nx, ny, nz, dtype)
    weights = _component_weights(nx, ny, nz, dtype)
    descs = []
    arrays = []
    for out_c, in_c, sign, ax, kind in _BLOCKS:
        dp, dd = axes[2 - ax]  # axes tuple is (x, y, z); ax 0 = z
        w_in = weights[in_c]
        for off, coef in _bidiag_taps(kind, dp, dd):
            per_axis = []
            for a in range(3):
                if a == ax:
                    c = coef.copy()
                    w = w_in[a]
                    # scale by input-column weight at shifted index
                    out_len = c.shape[0]
                    ii = np.arange(out_len) + off
                    valid = (ii >= 0) & (ii < w.shape[0])
                    c[valid] *= w[ii[valid]]
                    c[~valid] = 0.0
                    per_axis.append(c)
                else:
                    per_axis.append(w_in[a].copy())
            per_axis[0] = per_axis[0] * sign
            descs.append((out_c, in_c, ax, off))
            arrays.append(tuple(per_axis))
    return tuple(descs), arrays


class MaxwellOperator(LinearOperator):
    """Matrix-free A = D @ diag(w) as 24 separable stencil taps on the flat
    logical state: (n,) for `mv`, block-major (p, n) for `mm`.  The taps'
    1-D weights (wz, wy, wx) are registered buffers."""

    def __init__(self, nx, ny, nz, descs, tap_arrays):
        super().__init__()
        self.nx, self.ny, self.nz = nx, ny, nz
        self.descs = tuple(descs)
        self.comp_shapes = maxwell_component_shapes(nx, ny, nz)
        self.comp_sizes = tuple(int(np.prod(s)) for s in self.comp_shapes)
        self.n = int(sum(self.comp_sizes))
        for i, tap in enumerate(tap_arrays):
            for axis, w in zip("zyx", tap):
                self.register_buffer(f"w{axis}_{i}", torch.as_tensor(w))

    @classmethod
    def create(cls, nx: int, ny: int, nz: int, dtype=torch.float32,
               device="cuda") -> "MaxwellOperator":
        """The weights are built in f64 and rounded once to dtype, as the
        JAX `create` does."""
        device = target_device(device)
        descs, arrays = _build_taps(nx, ny, nz, np.float64)
        return cls(nx, ny, nz, descs, [
            tuple(torch.as_tensor(w).to(device=device, dtype=dtype) for w in tap)
            for tap in arrays
        ])

    @classmethod
    def from_arrays(cls, nx: int, ny: int, nz: int, tap_arrays, *,
                    dtype=None, device="cuda") -> "MaxwellOperator":
        """The operator from tap weights made elsewhere (e.g. the JAX
        operator's ``op.tap_arrays`` as NumPy arrays); the tap metadata is
        rebuilt from the geometry.  dtype None keeps the arrays' own."""
        device = target_device(device)
        descs, ref = _build_taps(nx, ny, nz, np.float64)
        taps = [tuple(np.asarray(w) for w in tap) for tap in tap_arrays]
        if [tuple(w.shape for w in t) for t in taps] != [
            tuple(w.shape for w in t) for t in ref
        ]:
            raise ValueError(
                f"tap arrays do not fit the {nx}x{ny}x{nz} geometry"
            )
        return cls(nx, ny, nz, descs, [
            tuple(torch.tensor(w, dtype=dtype, device=device) for w in tap)
            for tap in taps
        ])

    @property
    def tap_arrays(self):
        return [tuple(getattr(self, f"w{axis}_{i}") for axis in "zyx")
                for i in range(len(self.descs))]

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.wz_0.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x[None])[0]

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """Block-major (p, n) -> A X.  Each input component is padded once
        by one on every spatial axis; a tap is then a shifted slice of it
        times its three 1-D weights, multiplied in one axis at a time, and
        each output component sums its four taps in tap order (the JAX
        `_apply`'s arithmetic, so the two agree to rounding)."""
        p = X.shape[0]
        xs, o = [], 0
        for s, sz in zip(self.comp_shapes, self.comp_sizes):
            xs.append(X[:, o : o + sz].reshape((p,) + s))
            o += sz
        xpads = {}
        contribs = [[] for _ in range(6)]
        for (out_c, in_c, ax, off), (wz, wy, wx) in zip(self.descs,
                                                          self.tap_arrays):
            if in_c not in xpads:
                xpads[in_c] = F.pad(xs[in_c], (1, 1, 1, 1, 1, 1))
            start = [1, 1, 1]
            start[ax] += off
            zl, yl, xl = self.comp_shapes[out_c]
            v = xpads[in_c][:, start[0] : start[0] + zl,
                            start[1] : start[1] + yl, start[2] : start[2] + xl]
            v = v * wz.view(-1, 1, 1)
            v = v * wy.view(1, -1, 1)
            v = v * wx.view(1, 1, -1)
            contribs[out_c].append(v)
        ys = [c[0] + c[1] + c[2] + c[3] for c in contribs]
        return torch.cat([y.reshape(p, -1) for y in ys], dim=1)


def _bidiag_dense(kind: str, dp: np.ndarray, dd: np.ndarray) -> np.ndarray:
    n = dd.shape[0]
    if kind == "bwd":
        m = np.zeros((n + 1, n))
        for i in range(n):
            m[i, i] = 1.0 / dp[i]
        for i in range(1, n + 1):
            m[i, i - 1] = -1.0 / dp[i]
        return m
    else:
        m = np.zeros((n, n + 1))
        for i in range(n):
            m[i, i] = -1.0 / dd[i]
            m[i, i + 1] = 1.0 / dd[i]
        return m


def maxwell_scipy(nx: int, ny: int, nz: int):
    """Assemble (D, w) with scipy: D the curl-pair matrix, w the signed
    diagonal weight vector; A = D @ diag(w).  Mirrors the *math* of
    build_A_ell.hpp:10-252 via Kronecker products.  The f64 oracle of the
    port's tests."""
    import scipy.sparse as sp

    axes = _grids(nx, ny, nz, np.float64)
    weights = _component_weights(nx, ny, nz, np.float64)
    shapes = maxwell_component_shapes(nx, ny, nz)
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)])

    n = int(offsets[-1])
    blocks = []
    for out_c, in_c, sign, ax, kind in _BLOCKS:
        dp, dd = axes[2 - ax]
        bi = sp.csr_matrix(_bidiag_dense(kind, dp, dd))
        facs = []
        for a in range(3):
            if a == ax:
                facs.append(bi)
            else:
                facs.append(sp.identity(shapes[out_c][a], format="csr"))
        blk = sign * sp.kron(facs[0], sp.kron(facs[1], facs[2], format="csr"), format="csr")
        # raw D block (no column weights; sign here includes the -1 for H
        # columns, so compensate: D's own sign excludes the weight sign).
        blocks.append((out_c, in_c, blk))

    # one sparse block matrix (the JAX package assigns each block into a
    # lil_matrix, which takes minutes at N=32; the entries are the same)
    grid = [[None] * 6 for _ in range(6)]
    for out_c, in_c, blk in blocks:
        # Undo the folded H-column sign to recover the raw D entries:
        s = -1.0 if in_c >= _H1 else 1.0
        grid[out_c][in_c] = blk * s
    D = sp.bmat(grid, format="csr")
    assert D.shape == (n, n)

    w = np.concatenate(
        [
            (1.0 if c < _H1 else -1.0)
            * np.kron(weights[c][0], np.kron(weights[c][1], weights[c][2]))
            for c in range(6)
        ]
    )
    return D.tocsr(), w


def assemble_maxwell_A(nx: int, ny: int, nz: int):
    """A = D @ diag(w): the symmetric operator the Lanczos driver uses
    (test_lanczos.cu:45,191)."""
    import scipy.sparse as sp

    D, w = maxwell_scipy(nx, ny, nz)
    return (D @ sp.diags(w)).tocsr()


def maxwell_ell_operator(nx: int, ny: int, nz: int, dtype=torch.float32,
                         device="cuda"):
    """The assembled operator as width-4 ELL (`--operator ell`): the
    gathered-SpMV counterpart of the matrix-free stencil, in plain torch.
    The JAX package always builds it in f32 (its planes come from a native
    packer with no dtype); the port honours dtype."""
    from lanczos_tpu_torch.ops.formats import ell_from_scipy

    return ell_from_scipy(assemble_maxwell_A(nx, ny, nz), dtype=dtype,
                          width=4, device=device)


def maxwell_interleave_perm(nx: int, ny: int, nz: int) -> np.ndarray:
    """Symmetric z-interleaved ordering of the assembled Maxwell operator:
    unknowns sorted by (z, component, y, x) instead of component-major.
    The natural layout puts the curl coupling ~n/2 away, beyond any band
    window; plain RCM restores the band but scatters the k-th nonzeros of
    neighbouring rows over windows (~34 planes per chunk).  This ordering
    collapses the band to ~2 z-slabs and keeps 128 consecutive rows on one
    component's (y, x) run.  Use as
    `windowed_from_ell(ell, perm=maxwell_interleave_perm(...))`."""
    shapes = maxwell_component_shapes(nx, ny, nz)
    zs, cs, ys, xs = [], [], [], []
    for c, (sz, sy, sx) in enumerate(shapes):
        z, y, x = np.indices((sz, sy, sx)).reshape(3, -1)
        zs.append(z)
        ys.append(y)
        xs.append(x)
        cs.append(np.full(z.shape, c, np.int64))
    key = [np.concatenate(a) for a in (xs, ys, cs, zs)]
    return np.lexsort(key).astype(np.int64)  # the last key (z) is primary
