"""Windowed-ELL: assembled general sparse matrices, host side (port of the
planner and operators of `lanczos_tpu/ops/pallas/window_ell.py`).

The matrix is re-packed once on the host into planes:

  * rows go in CHUNKS of 128 (one chunk = 128 output rows, one per lane);
  * each chunk's nonzeros are packed into PLANES: plane j of a chunk holds
    at most one nonzero per row, and all its column indices fall inside one
    256-wide, 128-aligned window of x, so a column is the plane's 128-block
    offset plus a uint8 local index;
  * GROUPS of cpb * spg chunks share one window base `wb` (the band of x
    the group reads), and a plane's offset counts 128-blocks from it.

The planner and its geometry (cpb=16, spg=16, ppc_cap=48, wsz_cap=2^20,
the per-group base) are the JAX package's, so the port's plans pick the
same planes, raise `PlanError` in the same cases and report the same
`ppc` and `wsz`.  Dropped, as Mosaic (TPU) artifacts: the cpb*ppc % 8
plane pad, the int8 raw-bit indices in 32-row slabs, the rank-3 offsets
and the 8-row sublane pad of `pack`.  So a state is (p, n128) for any
p >= 1.  The layout here:

  planes_data  (C_pad*ppc, 128)  state dtype
  planes_lidx  (C_pad*ppc, 128)  uint8, local index in [0, 256)
  planes_off   (C_pad*ppc,)      int32, 128-blocks from the group's wb
  wb           (ng,)             int32, group window base (elements)
  perm         (n,) or (0,)      int64, build-time symmetric permutation

The SpMM on those planes is K8 (`ops/kernels/window_ell.py`, CUDA
`windowed_spmm_kernel`; its plain torch version on CPU tensors).  Chunks
past the matrix and empty lanes hold value 0 at offset 0, so the pad
region of a padded state stays exactly zero from call to call.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_tpu_torch.ops.formats import np_dtype, to_buffer
from lanczos_tpu_torch.ops.kernels.window_ell import plane_columns, windowed_spmm
from lanczos_tpu_torch.ops.operator import LinearOperator, target_device

LANES = 128
WINDOW = 2 * LANES  # a plane's x window: two aligned 128-blocks


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Host-side planner
# ---------------------------------------------------------------------------


class PlanError(ValueError):
    """The matrix cannot be packed within the configured caps (too many
    planes per chunk or too wide a band window): the caller falls back to
    a gathered container."""


def _pack_planes(indptr, indices, data, n_rows, ppc_cap):
    """Pack a CSR matrix into (chunk, plane) layout, plane slots by
    within-row position k (tight for banded orderings).

    Returns (planes_data (C, PPC, 128), planes_lidx (C, PPC, 128) int32 in
    [0, 256), planes_fabs (C, PPC) int64 absolute 128-block offset, -1 for
    empty planes)."""
    n_chunks = -(-n_rows // LANES)
    rows_pad = n_chunks * LANES
    per_row = np.diff(indptr)
    width = int(per_row.max()) if n_rows else 0
    width = max(width, 1)

    # ELL view (rows_pad, width); invalid slots flagged
    ell_idx = np.zeros((rows_pad, width), np.int64)
    ell_dat = np.zeros((rows_pad, width), data.dtype)
    valid = np.zeros((rows_pad, width), bool)
    rr = np.repeat(np.arange(n_rows), per_row)
    # within-row position of each nonzero: its global position minus its
    # row's start
    kk = (
        np.arange(len(indices), dtype=np.int64)
        - np.repeat(indptr[:-1].astype(np.int64), per_row)
        if len(indices)
        else np.zeros(0, np.int64)
    )
    ell_idx[rr, kk] = indices
    ell_dat[rr, kk] = data
    valid[rr, kk] = True

    idx3 = ell_idx.reshape(n_chunks, LANES, width)
    dat3 = ell_dat.reshape(n_chunks, LANES, width)
    val3 = valid.reshape(n_chunks, LANES, width)

    f3 = idx3 >> 7  # 128-block id of each nonzero
    BIG = 1 << 60
    fmin = np.where(val3, f3, BIG).min(axis=1)  # (C, width)
    fmax = np.where(val3, f3, -1).max(axis=1)  # (C, width)
    has = val3.any(axis=1)  # (C, width)
    single = has & (fmax <= fmin + 1)  # fits one 256-wide window
    multi = has & ~single

    # planes per (chunk, k): 0 empty / 1 single / counted for multi
    ngroups = single.astype(np.int64)
    multi_groups: dict[tuple[int, int], list[np.ndarray]] = {}
    if multi.any():
        for c, k in zip(*np.nonzero(multi)):
            v = val3[c, :, k]
            fs = f3[c, v, k]
            order = np.argsort(fs, kind="stable")
            lanes = np.nonzero(v)[0][order]
            fs = fs[order]
            groups = []
            start = 0
            while start < len(fs):
                base = fs[start]
                end = start
                while end < len(fs) and fs[end] <= base + 1:
                    end += 1
                groups.append(lanes[start:end])
                start = end
            multi_groups[(int(c), int(k))] = groups
            ngroups[c, k] = len(groups)

    ppc = int(ngroups.sum(axis=1).max()) if n_chunks else 1
    ppc = max(ppc, 1)
    if ppc > ppc_cap:
        raise PlanError(f"planes/chunk {ppc} exceeds cap {ppc_cap}")

    planes_dat = np.zeros((n_chunks, ppc, LANES), data.dtype)
    planes_lidx = np.zeros((n_chunks, ppc, LANES), np.int32)
    planes_fabs = np.full((n_chunks, ppc), -1, np.int64)

    # slot base of (c, k) = planes of the earlier k
    slot_base = np.zeros_like(ngroups)
    slot_base[:, 1:] = np.cumsum(ngroups, axis=1)[:, :-1]

    # bulk fill of the single-window planes (the banded common case)
    if single.any():
        cs, ks = np.nonzero(single)
        slots = slot_base[cs, ks]
        fa = fmin[cs, ks]
        planes_fabs[cs, slots] = fa
        lane_mask = val3[cs, :, ks]  # (nsel, LANES)
        lid = (idx3[cs, :, ks] - (fa << 7)[:, None]).astype(np.int32)
        planes_lidx[cs, slots] = np.where(lane_mask, lid, 0)
        planes_dat[cs, slots] = np.where(lane_mask, dat3[cs, :, ks], 0)

    for (c, k), groups in multi_groups.items():
        s = slot_base[c, k]
        for gi, lanes in enumerate(groups):
            fa = int(f3[c, lanes[0], k])
            planes_fabs[c, s + gi] = fa
            planes_lidx[c, s + gi, lanes] = (
                idx3[c, lanes, k] - (fa << 7)
            ).astype(np.int32)
            planes_dat[c, s + gi, lanes] = dat3[c, lanes, k]

    return planes_dat, planes_lidx, planes_fabs


def _pack_planes_greedy(indptr, indices, data, n_rows, ppc_cap,
                        count_only=False):
    """Aligned-window greedy packing: a plane is (chunk, 256-aligned
    window, s) with s the entry's rank within its (row, window), so a
    plane never mixes windows and never collides lanes.  Near the optimum
    sum_w max_lane count(lane, w) where the k-th nonzeros of a chunk's rows
    scatter across windows (RCM orderings); `windowed_from_scipy` keeps
    whichever packing gives fewer planes."""
    per_row = np.diff(indptr)
    rr = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    cols = np.asarray(indices, np.int64)
    n_chunks = max(-(-n_rows // LANES), 1)
    if len(cols) == 0:
        if count_only:
            return 1
        return (
            np.zeros((n_chunks, 1, LANES), data.dtype),
            np.zeros((n_chunks, 1, LANES), np.int32),
            np.full((n_chunks, 1), -1, np.int64),
        )
    chunk = rr >> 7
    lane = rr & 127
    w = cols >> 8
    # rank s within (row, window): CSR columns are sorted per row, so equal
    # (row, w) entries are consecutive
    grp = rr * (int(w.max()) + 2) + w
    first = np.ones(len(grp), bool)
    first[1:] = grp[1:] != grp[:-1]
    starts = np.nonzero(first)[0]
    s = np.arange(len(grp), dtype=np.int64) - np.repeat(
        starts, np.diff(np.append(starts, len(grp)))
    )
    # plane id within chunk = rank of (w, s) among the chunk's uniques
    ws = w * (int(s.max()) + 1) + s
    order = np.lexsort((ws, chunk))
    ch_o, ws_o = chunk[order], ws[order]
    new_plane = np.ones(len(order), bool)
    new_plane[1:] = (ch_o[1:] != ch_o[:-1]) | (ws_o[1:] != ws_o[:-1])
    pid_o = np.cumsum(new_plane) - 1  # global plane id in sorted order
    pid_first = np.nonzero(new_plane)[0]
    pid_chunk = ch_o[pid_first]
    ppc_per_chunk = np.bincount(pid_chunk, minlength=n_chunks)
    ppc = int(max(ppc_per_chunk.max(), 1))
    if count_only:
        return ppc
    if ppc > ppc_cap:
        raise PlanError(f"planes/chunk {ppc} exceeds cap {ppc_cap}")
    # local plane index = pid - first pid of its chunk
    first_of_chunk = np.ones(len(order), bool)
    first_of_chunk[1:] = ch_o[1:] != ch_o[:-1]
    foc = np.nonzero(first_of_chunk)[0]
    chunk_pid_base = np.zeros(n_chunks, np.int64)
    chunk_pid_base[ch_o[foc]] = pid_o[foc]
    lpid_o = pid_o - chunk_pid_base[ch_o]
    planes_dat = np.zeros((n_chunks, ppc, LANES), data.dtype)
    planes_lidx = np.zeros((n_chunks, ppc, LANES), np.int32)
    planes_fabs = np.full((n_chunks, ppc), -1, np.int64)
    lane_o = lane[order]
    planes_dat[ch_o, lpid_o, lane_o] = np.asarray(data)[order]
    planes_lidx[ch_o, lpid_o, lane_o] = (cols[order] & 0xFF).astype(np.int32)
    planes_fabs[ch_o, lpid_o] = 2 * w[order]
    return planes_dat, planes_lidx, planes_fabs


def _assemble(planes_dat, planes_lidx, planes_fabs, n, m, nnz, cpb, spg,
              wsz_cap):
    """Pad the chunks to whole groups, place each group's window base and
    make the offsets relative to it.  Returns the port's layout as NumPy
    arrays and the static geometry."""
    n_chunks, ppc, _ = planes_dat.shape
    chunks_per_group = cpb * spg
    # pad the chunk count so that the padded x length equals the padded y
    # length: square operators then chain through `padded_mm` with no pad
    # or slice copies between calls
    min_x_chunks = _round_up(m, LANES) // LANES + 1
    ng = max(-(-max(n_chunks, min_x_chunks) // chunks_per_group), 1)
    c_pad = ng * chunks_per_group

    def pad_planes(x, fill=0):
        out = np.full((c_pad, ppc) + x.shape[2:], fill, x.dtype)
        out[:n_chunks] = x
        return out

    planes_dat = pad_planes(planes_dat)
    planes_lidx = pad_planes(planes_lidx)
    planes_fabs = pad_planes(planes_fabs, fill=-1)
    n128 = c_pad * LANES  # >= m + 128

    fabs_g = planes_fabs.reshape(ng, chunks_per_group * ppc)
    used = fabs_g >= 0
    fmin_g = np.where(used, fabs_g, 1 << 60).min(axis=1)
    fmax_g = np.where(used, fabs_g, -1).max(axis=1)
    empty_g = ~used.any(axis=1)
    fmin_g = np.where(empty_g, 0, fmin_g)
    fmax_g = np.where(empty_g, 0, fmax_g)

    wsz = int(((fmax_g - fmin_g).max() + 2) * LANES)
    wsz = min(max(wsz, WINDOW), n128)
    if wsz > wsz_cap:
        raise PlanError(f"band window {wsz} exceeds cap {wsz_cap}")

    wb = np.maximum(np.minimum(fmin_g * LANES, n128 - wsz), 0).astype(np.int64)
    off = planes_fabs - (wb // LANES).repeat(chunks_per_group)[:, None]
    off = np.where(planes_fabs >= 0, off, 0)
    # every column the kernel forms stays below n128
    assert off.min() >= 0 and (off.max() + 2) * LANES <= wsz, "window math"
    arrays = (
        planes_dat.reshape(-1, LANES),
        planes_lidx.reshape(-1, LANES).astype(np.uint8),
        off.reshape(-1).astype(np.int32),
        wb.astype(np.int32),
    )
    geometry = dict(n_rows_true=n, n_cols_true=m, ppc=ppc, cpb=cpb, spg=spg,
                    wsz=wsz, n128=n128, nnz_true=nnz)
    return arrays, geometry


def windowed_from_scipy(
    a,
    dtype=torch.float32,
    cpb: int = 16,
    spg: int = 16,
    ppc_cap: int = 48,
    wsz_cap: int = 1 << 20,
    reorder: str = "auto",
    perm=None,
    device="cuda",
) -> "WindowedEllMatrix":
    """Build the windowed plan from a scipy sparse matrix (host side, once
    per matrix: the reference's `change_order(4)` preprocessing).

    reorder: 'rcm' applies a symmetric reverse-Cuthill-McKee permutation
    (square matrices) so that the band window stays small; 'auto' applies
    it only when the raw bandwidth would exceed the window cap; 'none'
    never.  An explicit `perm` (new index -> old index) overrides reorder.
    The result then represents P A P^T (same spectrum): use
    .permute()/.unpermute() on vectors at the boundaries."""
    import scipy.sparse as sp

    if reorder not in ("none", "rcm", "auto"):
        raise ValueError(f"unknown reorder={reorder!r}")
    device = target_device(device)
    if not sp.issparse(a):
        a = sp.csr_matrix(np.asarray(a))
    a = a.tocsr()
    a.sum_duplicates()
    n, m = a.shape
    npdt = np_dtype(dtype)

    if perm is not None:
        perm = np.asarray(perm)
        a = a[perm][:, perm].tocsr()
        a.sum_duplicates()
    elif n == m and reorder != "none":
        coo = a.tocoo()
        bw = (
            int(np.abs(coo.col.astype(np.int64) - coo.row).max())
            if coo.nnz
            else 0
        )
        # the per-group window must hold ~2*bandwidth + the group's rows
        if reorder == "rcm" or 2 * bw + cpb * spg * LANES + WINDOW > wsz_cap:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
            a = a[perm][:, perm].tocsr()
            a.sum_duplicates()

    # two candidate packings: per-k (tight for banded orderings) and the
    # aligned-window greedy one (immune to the k-th-nonzero scatter of RCM
    # orderings).  The greedy count costs an O(nnz log nnz) sort, so it
    # only runs when per-k lands well above its lower bound (the largest
    # row count); the packing with fewer planes wins.
    mrow = int(np.diff(a.indptr).max()) if n else 1
    try:
        planes = _pack_planes(a.indptr, a.indices, a.data.astype(npdt), n,
                              ppc_cap)
        if planes[0].shape[1] > max(1.5 * mrow, mrow + 2):
            ppc_g = _pack_planes_greedy(a.indptr, a.indices, a.data, n,
                                        1 << 30, count_only=True)
            if ppc_g < planes[0].shape[1]:
                planes = _pack_planes_greedy(a.indptr, a.indices,
                                             a.data.astype(npdt), n, ppc_cap)
    except PlanError:
        planes = _pack_planes_greedy(a.indptr, a.indices, a.data.astype(npdt),
                                     n, ppc_cap)
    arrays, geometry = _assemble(*planes, n, m, int(a.nnz), cpb, spg, wsz_cap)
    return WindowedEllMatrix(*arrays, perm, **geometry, device=device)


def windowed_from_ell(ell, cpb: int = 16, spg: int = 16, ppc_cap: int = 48,
                      wsz_cap: int = 1 << 20, reorder: str = "auto",
                      perm=None, device=None) -> "WindowedEllMatrix":
    """Re-pack an `EllMatrix` (one device-to-host copy at setup); device
    None keeps the ELL matrix's device."""
    import scipy.sparse as sp

    data = ell.data.cpu().numpy()
    idx = ell.indices.cpu().numpy()
    n, m = ell.shape
    rows = np.repeat(np.arange(data.shape[0]), data.shape[1])
    mask = (data.reshape(-1) != 0) & (rows < n)
    coo = sp.coo_matrix(
        (data.reshape(-1)[mask], (rows[mask], idx.reshape(-1)[mask])),
        shape=(n, m),
    )
    return windowed_from_scipy(
        coo.tocsr(), dtype=ell.dtype, cpb=cpb, spg=spg, ppc_cap=ppc_cap,
        wsz_cap=wsz_cap, reorder=reorder, perm=perm,
        device=ell.data.device if device is None else device,
    )


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


class WindowedEllMatrix(LinearOperator):
    """Windowed-ELL general sparse matrix (see the module docstring).

    Chunk c (128 rows) owns planes [c*ppc, (c+1)*ppc); its group is
    c // (cpb*spg).  Plane arrays, window bases and the permutation are
    registered buffers; the geometry is plain ints."""

    def __init__(self, planes_data, planes_lidx, planes_off, wb, perm, *,
                 n_rows_true, n_cols_true, ppc, cpb, spg, wsz, n128,
                 nnz_true, dtype=None, device="cuda"):
        super().__init__()
        device = target_device(device)

        perm = np.zeros((0,), np.int64) if perm is None else np.asarray(perm)
        for name, x, dt in (("planes_data", planes_data, dtype),
                            ("planes_lidx", planes_lidx, torch.uint8),
                            ("planes_off", planes_off, torch.int32),
                            ("wb", wb, torch.int32),
                            ("perm", perm, torch.int64)):
            self.register_buffer(name, to_buffer(x, device, dt))
        self.n_rows_true, self.n_cols_true = int(n_rows_true), int(n_cols_true)
        self.ppc, self.cpb, self.spg = int(ppc), int(cpb), int(spg)
        self.wsz, self.n128, self.nnz_true = int(wsz), int(n128), int(nnz_true)
        c_pad = self.planes_data.shape[0] // self.ppc
        if (self.planes_data.shape != (c_pad * self.ppc, LANES)
                or self.planes_lidx.shape != self.planes_data.shape
                or self.planes_off.shape != (c_pad * self.ppc,)
                or c_pad * LANES != self.n128
                or c_pad != self.ng * self.chunks_per_group):
            raise ValueError("plane arrays do not fit the geometry")
        # K8 gathers x[wb + off * 128 + lidx] with no bounds logic, so
        # every slot must fall in its group's band and every band below
        # n128: lidx < 256, so (off + 2) * 128 <= wsz suffices.  Checked
        # once here.
        if self.planes_off.numel() and (
                int(self.planes_off.min()) < 0
                or (int(self.planes_off.max()) + 2) * LANES > self.wsz
                or int(self.wb.min()) < 0
                or int(self.wb.max()) + self.wsz > self.n128):
            raise ValueError("plane offsets or window bases leave the band")

    @classmethod
    def from_arrays(cls, planes_data, planes_lidx, planes_off, wb, perm, *,
                    n_rows_true, n_cols_true, ppc, cpb, spg, wsz, n128,
                    nnz_true, interpret=None, dtype=None, device="cuda"):
        """The operator from a JAX `WindowedEllMatrix`'s arrays (NumPy) and
        static fields: planes_lidx (steps, spb32, 128) int8 raw bits,
        planes_off (steps, 8, spb) int32.  Drops the Mosaic pads (the
        32-row index slab tail, the 8-row offset block and the zero planes
        that made cpb*ppc a multiple of 8) and reads each uint8 index from
        its raw bits.  JAX's `interpret` flag has no meaning here."""
        data = np.asarray(planes_data)
        lidx3 = np.asarray(planes_lidx)
        off3 = np.asarray(planes_off)
        spb = cpb * ppc
        lidx = lidx3[:, :spb, :].reshape(-1, LANES).view(np.uint8)
        off = off3[:, 0, :].reshape(-1)
        c_pad = data.shape[0] // ppc
        # the raw ppc: the fewest planes that JAX's pad rule rounds up to
        # ppc and beyond which every plane is zero
        dat3 = data.reshape(c_pad, ppc, LANES)
        zero_tail = ~dat3.any(axis=(0, 2))
        ppc_raw = ppc
        for q in range(ppc - 1, 0, -1):
            rounded = q
            while (cpb * rounded) % 8:
                rounded += 1
            if rounded != ppc or not zero_tail[q:].all():
                break
            ppc_raw = q
        keep = slice(0, ppc_raw)
        return cls(
            dat3[:, keep].reshape(-1, LANES),
            lidx.reshape(c_pad, ppc, LANES)[:, keep].reshape(-1, LANES),
            off.reshape(c_pad, ppc)[:, keep].reshape(-1),
            np.asarray(wb), np.asarray(perm),
            n_rows_true=n_rows_true, n_cols_true=n_cols_true, ppc=ppc_raw,
            cpb=cpb, spg=spg, wsz=wsz, n128=n128, nnz_true=nnz_true,
            dtype=dtype, device=device,
        )

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.planes_data.dtype

    @property
    def nnz(self) -> int:
        return self.nnz_true

    @property
    def n_chunks_pad(self) -> int:
        return self.planes_data.shape[0] // self.ppc

    @property
    def ng(self) -> int:
        return self.wb.shape[0]

    @property
    def chunks_per_group(self) -> int:
        return self.cpb * self.spg

    @property
    def is_permuted(self) -> bool:
        return self.perm.shape[0] > 0

    def device_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def permute(self, x: torch.Tensor) -> torch.Tensor:
        """Original-ordering vector(s) -> this operator's ordering (the
        identity if built with reorder='none').  One gather, at setup
        boundaries only."""
        if not self.is_permuted:
            return x
        return x.index_select(-1, self.perm)

    def unpermute(self, y: torch.Tensor) -> torch.Tensor:
        if not self.is_permuted:
            return y
        out = torch.zeros_like(y)
        out[..., self.perm] = y
        return out

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x[None, :])[0]

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """Block-major SpMM: X (p, n) -> (p, n_rows), in the operator's
        (possibly permuted) ordering."""
        return self.padded_mm(self.pack(X))[:, : self.n_rows_true]

    # -- the chained path: states stay padded -----------------------------

    def pack(self, X: torch.Tensor) -> torch.Tensor:
        """(p, n) or (n,) -> the kernel's (p, n128) state, zero-padded."""
        if X.ndim == 1:
            X = X[None, :]
        p, n = X.shape
        if n == self.n128:
            return X.contiguous()
        out = torch.zeros((p, self.n128), dtype=X.dtype, device=X.device)
        out[:, :n] = X
        return out

    def unpack(self, Xp: torch.Tensor, p: int | None = None) -> torch.Tensor:
        out = Xp[:, : self.n_rows_true]
        return out[0] if p is None else out[:p]

    def padded_mm(self, Xp: torch.Tensor, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """K8 on a packed (p, n128) state, returning (p, n128): no pad or
        slice copies, so a square operator's output chains into its next
        call.  `out`, if given, must not overlap Xp."""
        return windowed_spmm(self, Xp, out)

    def to_dense(self) -> torch.Tensor:
        """Dense reconstruction (tests)."""
        C, dev = self.n_chunks_pad, self.planes_data.device
        col = plane_columns(self).clamp(0, self.n_cols_true - 1)
        rows = (torch.arange(C, device=dev)[:, None, None] * LANES
                + torch.arange(LANES, device=dev)[None, None, :])
        rows = rows.expand(-1, self.ppc, -1)
        out = torch.zeros((C * LANES, self.n_cols_true), dtype=self.dtype,
                          device=dev)
        out.index_put_((rows.reshape(-1), col.reshape(-1)),
                       self.planes_data.reshape(-1), accumulate=True)
        return out[: self.n_rows_true]


class PaddedWindowedOperator(LinearOperator):
    """A WindowedEllMatrix whose mv/mm run directly on the kernel's padded
    (p, n128) state: no pad or slice copies per call, so the Lanczos and
    FDTD loops chain at the kernel's speed.  The pad region stays exactly
    zero across calls, so Grams and dot products over the padded state are
    exact.  Build states with `base.pack()`, read them with
    `base.unpack()`; natural row i sits at padded position i.  Any block
    width p >= 1 works (mv runs K8 at p = 1)."""

    def __init__(self, base: WindowedEllMatrix):
        super().__init__()
        self.base = base

    @property
    def shape(self):
        return (self.base.n128, self.base.n128)

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def nnz(self) -> int:
        return self.base.nnz

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.padded_mm(x[None, :])[0]

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return self.base.padded_mm(X)
