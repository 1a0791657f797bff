"""Process group, data axis and the collectives of data-parallel training.

Port of ``parallel/mesh.py``. The JAX package shards the env (or scenario)
axis over a ``jax.sharding.Mesh`` and lets XLA turn every mean and gradient
into a ``psum``; here each rank is a process that owns one contiguous block
of that axis (:func:`block`, the blocks of ``NamedSharding(mesh,
P("data"))``), the policy is replicated, and the reductions are written out
as ``torch.distributed`` collectives (:func:`all_reduce_sum`,
:func:`all_gather_cat`). The backend is NCCL for a CUDA device and gloo for
the CPU, or the one named. gloo reduces CUDA tensors only in part, so under
gloo a CUDA tensor goes through the host for every collective.

Bring-up (:func:`init_distributed`): under ``torch.distributed.run``
(``RANK`` and ``WORLD_SIZE`` set) from the environment; with the JAX
signature's coordinator, process count and id over TCP; with neither, a world
of one over a local TCP store, so a run on one device still goes through the
collectives, as the JAX package's mesh of one device does.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import socket
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data axis over the default process group:
    ``world`` ranks, this one ``rank``, its ``device`` and the ``backend``."""
    world: int
    rank: int
    device: torch.device
    backend: str
    axis: str = DATA_AXIS
    # wall seconds this rank spent in collectives (the device synchronized around each)
    seconds: dict = dataclasses.field(default_factory=lambda: {"collectives": 0.0},
                                      compare=False)

    @property
    def staged(self) -> bool:
        """Whether collectives go through the host (gloo with a CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def default_backend(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: torch.device | str = "cpu",
                     backend: Optional[str] = None) -> bool:
    """Join the default process group; returns whether this call made it
    (False if it already existed). ``coordinator`` is ``host:port``."""
    if dist.is_initialized():
        return False
    backend = backend or default_backend(device)
    if num_processes is not None:
        if coordinator is None or process_id is None:
            raise ValueError("num_processes needs a coordinator and a process_id")
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init, world, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device: torch.device | str) -> torch.device:
    """``cuda:{LOCAL_RANK}`` for a CUDA device (two ranks on one card both
    set ``LOCAL_RANK=0``), else the device itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))


def make_mesh(device: torch.device | str = "cpu", axis: str = DATA_AXIS) -> Mesh:
    """This rank's :class:`Mesh` over the default group (which must exist)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    return Mesh(world=dist.get_world_size(), rank=dist.get_rank(),
                device=local_device(device), backend=dist.get_backend(), axis=axis)


def block_range(rank: int, world: int, n: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of rank ``rank`` when ``n`` rows split evenly over ``world``."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def block(mesh: Mesh, n: int) -> tuple[int, int]:
    """This rank's rows of an axis of ``n``: the JAX package's
    ``data_sharding(mesh)`` shard of device ``mesh.rank``."""
    return block_range(mesh.rank, mesh.world, n)


class _Timed:
    """Adds the wall time of its block to ``mesh.seconds["collectives"]``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _sync(self) -> float:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return time.perf_counter()

    def __enter__(self):
        self.t0 = self._sync()

    def __exit__(self, *exc):
        self.mesh.seconds["collectives"] += self._sync() - self.t0


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor on ``t``'s device)."""
    with _Timed(mesh):
        buf = t.detach().to("cpu" if mesh.staged else t.device, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return buf.to(t.device)


def all_gather_cat(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along axis 0
    in rank order."""
    with _Timed(mesh):
        buf = t.detach().to("cpu" if mesh.staged else t.device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(mesh.world)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(t.device)


def checksum(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor], what: str = "tensors") -> None:
    """Raise unless every rank holds the same bits of ``tensors`` (what the
    JAX package's replicated sharding guarantees by construction): one
    all-gather of each rank's checksum."""
    digest = np.frombuffer(bytes.fromhex(checksum(tensors)), dtype=np.int64).copy()
    every = all_gather_cat(mesh, torch.from_numpy(digest).to(mesh.device)).view(mesh.world, -1)
    differ = [r for r in range(mesh.world) if not torch.equal(every[r], every[0])]
    if differ:
        raise RuntimeError(f"the replicated {what} differ between rank 0 and ranks {differ}")
