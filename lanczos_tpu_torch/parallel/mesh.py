"""The device mesh of the multi-device layer (port of
`lanczos_tpu/parallel/mesh.py`).

JAX's mesh is one object in one controller process that holds every
device, and GSPMD inserts the collectives.  Here each device is one
process (a rank) of a `torch.distributed` group, which `launch.run`
starts, and a `Mesh` is the calling rank's view of the 1-D ``rows`` axis:
its rank, the world size, its device, the group, and the collectives that
the distributed operator and the Lanczos methods call explicitly.  The
backend is NCCL on CUDA and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


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
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def any(self, flag: bool) -> bool:
        """True on every rank when flag is True on any: a branch on a value
        the device computed is taken by all ranks or by none, so no rank
        waits alone in the next collective."""
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def exchange(self, lo: torch.Tensor, hi: torch.Tensor):
        """The one-plane halo exchange (JAX's two `ppermute`s): sends lo to
        rank - 1 and hi to rank + 1, and returns (from_left, from_right),
        rank - 1's hi and rank + 1's lo, zeros at the two ends."""
        lo, hi = lo.contiguous(), hi.contiguous()
        from_left, from_right = torch.zeros_like(hi), torch.zeros_like(lo)
        ops = []
        if self.rank > 0:
            ops += [dist.P2POp(dist.isend, lo, self.rank - 1, self.group),
                    dist.P2POp(dist.irecv, from_left, self.rank - 1, self.group)]
        if self.rank < self.size - 1:
            ops += [dist.P2POp(dist.isend, hi, self.rank + 1, self.group),
                    dist.P2POp(dist.irecv, from_right, self.rank + 1, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right


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
