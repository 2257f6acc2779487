"""Data parallelism over ``torch.distributed`` (counterpart of
``medtok_tpu/parallel/mesh.py``).

The JAX package trains over a ``dp`` mesh axis; the port runs one process
per GPU, started by ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N``), and the process group takes the place of the axis.
Each rank trains on its contiguous block of every global batch, and the
collectives below do what the JAX step's ``pmean`` / ``psum`` /
``all_gather`` over ``dp`` do.

    dp = initialize_distributed(device)      # None under a plain `python` run
    trainer = Trainer(cfg, device=device, dp=dp)

``initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). On CUDA
it joins an NCCL group on the device ``LOCAL_RANK``, on the CPU a gloo
group. If NCCL fails, the run raises: it never switches to gloo. Under the launcher it makes a group even
at world size 1, so the collectives run there too.

Gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors; any other
collective on a CUDA tensor goes through host memory on gloo (never on
NCCL), and its name is added to ``STAGED_OPS``. The tensor-parallel
codebook sweep (``mesh_tp`` above 1) is not ported.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from medtok_tpu_torch import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)

#: collectives gloo takes on CUDA tensors; the others are staged through the host
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})
#: names of the collectives that were staged through host memory (gloo, CUDA tensors)
STAGED_OPS: set[str] = set()


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout generator: ``seed`` on rank 0 (so
    a single-device run keeps its draws), decorrelated on the others (the
    JAX step folds the ``dp`` axis index into its key)."""
    return seed + 1_000_003 * rank


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the default process group: its rank, the
    world size and the device its tensors live on."""

    rank: int
    world: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def _host_staged(self, op: str, tensor: torch.Tensor) -> bool:
        if tensor.is_cuda and op not in GLOO_CUDA_OPS and self.backend == "gloo":
            STAGED_OPS.add(op)
            return True
        return False

    def _all_reduce_flat_(self, tensors: list[torch.Tensor], divide: bool) -> int:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if divide:
            flat.div_(self.world)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [part.view_as(t) for t, part in zip(tensors, parts)])
        return flat.numel() * flat.element_size()

    def all_reduce_mean_(self, tensors: list[torch.Tensor]) -> int:
        """Replace each tensor (one dtype) by its mean over the ranks, through
        one flat buffer and one all-reduce; returns the buffer's bytes."""
        return self._all_reduce_flat_(tensors, divide=True)

    def all_reduce_sum_(self, tensors: list[torch.Tensor]) -> int:
        """As ``all_reduce_mean_``, the sum."""
        return self._all_reduce_flat_(tensors, divide=False)

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors (one shape) concatenated along dim 0 in rank
        order (JAX's tiled ``all_gather``)."""
        src = tensor.contiguous()
        if self._host_staged("all_gather", src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(tensor.device)

    def all_reduce_max(self, value: int) -> int:
        """The largest of the ranks' integers."""
        t = torch.tensor([value], dtype=torch.int64, device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor with rank ``src``'s."""
        for t in tensors:
            dist.broadcast(t, src)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable object, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src, device=self.comm_device)
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable object, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    @property
    def comm_device(self) -> torch.device:
        """Where a small tensor of the group's own (a count, a pickled
        object) lives: the card for NCCL, the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def launched() -> bool:
    """Whether this process runs under the launcher (or already joined a
    group)."""
    return (dist.is_available() and dist.is_initialized()) or "WORLD_SIZE" in os.environ


def world_size() -> int:
    """The group's size once joined, else the launcher's ``WORLD_SIZE``
    (1 under a plain run)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _current(device: torch.device) -> DataParallel:
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return DataParallel(dist.get_rank(), dist.get_world_size(), device)


def initialize_distributed(device=None) -> DataParallel | None:
    """Join the process group torchrun describes and return this rank's
    ``DataParallel``; None without a launcher (``WORLD_SIZE`` unset). A group
    the caller already made is taken as it is. ``device`` as
    ``resolve_device`` takes it: on CUDA the rank's device is
    ``LOCAL_RANK``."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return _current(device)
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT)
    return DataParallel(rank, world, device)


def warmup_collectives(dp: DataParallel | None) -> None:
    """A barrier and one small all-reduce, so the group's connections are
    made before the first step."""
    if dp is None:
        return
    dp.barrier()
    dp.all_reduce_max(0)


def check_mesh(dp: int, tp: int, world: int) -> None:
    """Raise unless a (dp, tp) mesh fits ``world`` ranks: ``dp`` -1 (every
    rank) or ``world``, ``tp`` 1."""
    if tp != 1:
        raise NotImplementedError(
            f"mesh_tp={tp}: the tensor-parallel codebook sweep is not ported to "
            "medtok_tpu_torch (ROADMAP Queue 1)")
    if dp not in (-1, world):
        raise ValueError(
            f"mesh_dp={dp} but the world size is {world}: launch one process a device "
            f"with `torchrun --nproc-per-node {dp}`, or pass mesh_dp -1")

