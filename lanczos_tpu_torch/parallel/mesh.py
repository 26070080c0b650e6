"""The device mesh of the multi-device layer (port of
`lanczos_tpu/parallel/mesh.py`).

JAX's mesh is one object in one controller process that holds every
device, and GSPMD inserts the collectives.  Here each device is one
process (a rank) of a `torch.distributed` group, which `launch.run`
starts, and a `Mesh` is the calling rank's view of the 1-D ``rows`` axis:
its rank, the world size, its device, the group, and the collectives that
the distributed operator and the Lanczos methods call explicitly.  The
backend is NCCL on CUDA and gloo on the CPU.

Every collective runs inside a span (`utils/tracing.py`): `lt.mesh.halo`
(a halo exchange: `exchange`, `halo_window`, `halo_strip`, the latter two
with their copies), `lt.mesh.reduce` (`all_reduce_`), `lt.mesh.gather`
(`all_gather`) and `lt.mesh.any` (the collective and its host read), and
counts itself under `mesh.halo`, `mesh.halo_bytes` (the bytes this rank
sends), `mesh.reduce`, `mesh.gather` and `mesh.any`.  The spans do not
nest in one another.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lanczos_tpu_torch.utils import tracing


def available_devices(device_type: str) -> int | None:
    """The devices ranks of `device_type` may use: the CUDA cards, or None
    (no limit) for CPU ranks."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return None
    raise ValueError(f"ranks run on 'cuda' or 'cpu', got {device_type!r}")


def check_devices(n_devices: int, device_type: str) -> None:
    """ValueError when `n_devices` ranks cannot each have a device of their
    own, as `lanczos_tpu/parallel/mesh.py:24-27` raises."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least 1 device, got {n_devices}")
    have = available_devices(device_type)
    if have is not None and n_devices > have:
        raise ValueError(
            f"requested {n_devices} devices, only {have} available"
        )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D mesh of `size` ranks, one device each."""

    rank: int
    size: int
    device: torch.device
    group: dist.ProcessGroup

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums t over the ranks, in place; returns t."""
        tracing.count("mesh.reduce")
        with tracing.span("lt.mesh.reduce"):
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        tracing.count("mesh.gather")
        with tracing.span("lt.mesh.gather"):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            return torch.stack(parts)

    def any(self, flag: bool) -> bool:
        """True on every rank when flag is True on any: a branch on a value
        the device computed is taken by all ranks or by none, so no rank
        waits alone in the next collective."""
        tracing.count("mesh.any")
        with tracing.span("lt.mesh.any"):
            t = torch.tensor([int(bool(flag))], device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
            return bool(t.item())

    def exchange(self, lo: torch.Tensor, hi: torch.Tensor):
        """The one-plane halo exchange (JAX's two `ppermute`s): sends lo to
        rank - 1 and hi to rank + 1, and returns (from_left, from_right),
        rank - 1's hi and rank + 1's lo, zeros at the two ends."""
        with tracing.span("lt.mesh.halo"):
            return self._exchange(lo, hi)

    def _exchange(self, lo: torch.Tensor, hi: torch.Tensor):
        lo, hi = lo.contiguous(), hi.contiguous()
        from_left, from_right = torch.zeros_like(hi), torch.zeros_like(lo)
        ops, sent = [], 0
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, lo, self.rank - 1, self.group),
                    dist.P2POp(dist.irecv, from_left, self.rank - 1, self.group)]
            sent += _nbytes(lo)
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, hi, self.rank + 1, self.group),
                    dist.P2POp(dist.irecv, from_right, self.rank + 1, self.group)]
            sent += _nbytes(hi)
        _count_halo(sent)
        _wait_all(ops)
        return from_left, from_right

    def halo_window(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """The halo-extended window ``[halo | x | halo]`` of this rank's
        block-major rows x (p, rows_loc), JAX's `_halo_exchange`
        (`dist_operator.py:52-84`): (p, rows_loc + 2 halo), zeros past the
        mesh ends.  halo == 0 returns x itself with no communication.
        Every rank must pass the same halo (the matrix's global one)."""
        if halo == 0:
            return x
        with tracing.span("lt.mesh.halo"):
            from_left, from_right = self._strips(x, halo)
            return torch.cat([from_left, x, from_right], dim=-1)

    def halo_strip(self, x: torch.Tensor, offset: int, rows: int,
                   halo: int) -> torch.Tensor:
        """A copy of the strip x (p, L) whose `halo` slots before and
        after its rows [offset, offset + rows) hold the neighbours' rows,
        zeros past the mesh ends; 0 < halo <= offset and offset + rows +
        halo <= L.  Every rank must pass the same halo."""
        with tracing.span("lt.mesh.halo"):
            work = x.clone(memory_format=torch.contiguous_format)
            lo, hi = offset - halo, offset + rows
            work[:, lo:offset], work[:, hi : hi + halo] = self._strips(
                x[:, offset:hi], halo)
            return work

    def _strips(self, x: torch.Tensor, halo: int):
        """(from_left, from_right), each (p, halo): the `halo` rows before
        and after this rank's rows x (p, rows_loc) in the global order,
        zeros past the mesh ends; halo > 0.  A halo of at most rows_loc
        moves exactly `halo` boundary columns each way (`exchange`); a
        wider one sends the whole block to the ranks at distance 1..hops,
        hops = ceil(halo / rows_loc), and receives theirs in one batch."""
        rows = x.shape[-1]
        hops = -(-halo // rows)
        if hops == 1:
            return self._exchange(x[..., :halo], x[..., rows - halo:])
        x = x.contiguous()
        left = [torch.zeros_like(x) for _ in range(hops)]  # ranks r-hops..r-1
        right = [torch.zeros_like(x) for _ in range(hops)]  # ranks r+1..r+hops
        ops = []
        for k in range(1, hops + 1):
            if self.rank - k >= 0:
                ops += [dist.P2POp(dist.isend, x, self.rank - k, self.group),
                        dist.P2POp(dist.irecv, left[hops - k], self.rank - k,
                                   self.group)]
            if self.rank + k < self.size:
                ops += [dist.P2POp(dist.isend, x, self.rank + k, self.group),
                        dist.P2POp(dist.irecv, right[k - 1], self.rank + k,
                                   self.group)]
        _count_halo(len(ops) // 2 * _nbytes(x))
        _wait_all(ops)
        return (torch.cat(left, dim=-1)[..., hops * rows - halo:],
                torch.cat(right, dim=-1)[..., :halo])

    def barrier(self) -> None:
        """Returns on each rank once every rank has called it (one
        all-reduce of a scalar on the mesh's device)."""
        self.all_reduce_(torch.zeros(1, device=self.device))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count_halo(sent: int) -> None:
    """One halo exchange that sends `sent` bytes from this rank."""
    tracing.count("mesh.halo")
    tracing.count("mesh.halo_bytes", sent)


def _wait_all(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The calling rank's mesh over all ranks of the initialized process
    group (`launch.run` sets it up): a rank on "cuda" holds card `rank`,
    one on "cpu" the CPU.  ValueError when more devices are asked for than
    exist, or than the group has ranks."""
    device_type = torch.device(device).type
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: run the function "
            "through lanczos_tpu_torch.parallel.launch.run"
        )
    size, rank = dist.get_world_size(), dist.get_rank()
    n = size if n_devices is None else int(n_devices)
    check_devices(n, device_type)
    if n != size:
        raise ValueError(
            f"requested {n} devices; the mesh spans all {size} ranks"
        )
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    return Mesh(rank, size, dev, dist.group.WORLD)
