"""The (dp, tp) mesh over ``torch.distributed`` (counterpart of
``medtok_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a (dp, tp) mesh; the port runs one
process per GPU, started by ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node dp*tp``), and process groups take the place of the axes.
Ranks are laid out as JAX's ``reshape(dp, tp)``: global rank = d * tp + t,
so the tp ranks of one data-parallel block are neighbours. Each dp block
trains on its contiguous block of every global batch; the tp ranks of a
block hold the same batch and split the work inside a step (the codebook
sweep's rows, the QA LLM's heads and vocabulary). The collectives below do
what the JAX step's ``pmean`` / ``psum`` / ``all_gather`` over an axis do,
each over the group of the axis it names.

    dp = initialize_distributed(device, tp=2)   # None under a plain `python` run
    trainer = Trainer(cfg, device=device, dp=dp)

``initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). On CUDA
it joins an NCCL group on the device ``LOCAL_RANK``, on the CPU a gloo
group. If NCCL fails, the run raises: it never switches to gloo. Under the
launcher it makes a group even at world size 1, so the collectives run
there too. With ``tp`` above 1 every rank creates every dp row's tp group
and every tp column's dp group, in one order (``dist.new_group`` needs all
ranks for each group).

Gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors; any other
collective on a CUDA tensor goes through host memory on gloo (never on
NCCL), and its name is added to ``STAGED_OPS``.
"""

from __future__ import annotations

import dataclasses
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


#: the axes a collective may name; None is the whole world
AXES = ("dp", "tp", None)


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the (dp, tp) mesh: its global rank, the
    world size, the device its tensors live on, the tp axis's size and the
    groups of its two axes (None: the axis is the whole world, or one rank).
    With ``tp_size`` 1 it is the data-parallel case: the dp axis is the
    world. Each collective takes the axis it runs over."""

    rank: int
    world: int
    device: torch.device
    tp_size: int = 1
    dp_group: object = None
    tp_group: object = None

    @property
    def dp_size(self) -> int:
        return self.world // self.tp_size

    @property
    def dp_index(self) -> int:
        """This rank's data-parallel block (its row of the mesh)."""
        return self.rank // self.tp_size

    @property
    def tp_index(self) -> int:
        """This rank's place inside its block (its column of the mesh)."""
        return self.rank % self.tp_size

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def size(self, axis: str | None) -> int:
        return {"dp": self.dp_size, "tp": self.tp_size, None: self.world}[axis]

    def group(self, axis: str | None):
        """The process group of ``axis`` (None: the default group)."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return {"dp": self.dp_group, "tp": self.tp_group, None: None}[axis]

    def alone(self, axis: str | None) -> bool:
        """Whether a collective over ``axis`` has nothing to do: the axis
        holds this rank only, inside a larger world. (A world of one still
        runs its collectives, over the default group.)"""
        return self.size(axis) == 1 and self.world > 1

    def global_rank(self, axis: str | None, index: int) -> int:
        """The global rank of the ``index``-th rank along ``axis`` that
        shares this rank's place on the other axis."""
        if axis == "dp":
            return index * self.tp_size + self.tp_index
        if axis == "tp":
            return self.dp_index * self.tp_size + index
        return index

    def _host_staged(self, op: str, tensor: torch.Tensor) -> bool:
        if tensor.is_cuda and op not in GLOO_CUDA_OPS and self.backend == "gloo":
            STAGED_OPS.add(op)
            return True
        return False

    def _all_reduce_flat_(self, tensors: list[torch.Tensor], divide: bool,
                          axis: str | None = "dp") -> int:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if not self.alone(axis):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group(axis))
            if divide:
                flat.div_(self.size(axis))
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [part.view_as(t) for t, part in zip(tensors, parts)])
        return flat.numel() * flat.element_size()

    def all_reduce_mean_(self, tensors: list[torch.Tensor], axis: str | None = "dp") -> int:
        """Replace each tensor (one dtype) by its mean over the ranks of
        ``axis``, through one flat buffer and one all-reduce; returns the
        buffer's bytes."""
        return self._all_reduce_flat_(tensors, True, axis)

    def all_reduce_sum_(self, tensors: list[torch.Tensor], axis: str | None = "dp") -> int:
        """As ``all_reduce_mean_``, the sum."""
        return self._all_reduce_flat_(tensors, False, axis)

    def all_reduce_(self, tensor: torch.Tensor, axis: str | None, op: str = "sum"
                    ) -> torch.Tensor:
        """One tensor reduced in place over ``axis`` (``op`` "sum" or "max")."""
        if not self.alone(axis):
            red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            dist.all_reduce(tensor, op=red, group=self.group(axis))
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str | None = "dp") -> torch.Tensor:
        """The tensors (one shape) of the ranks of ``axis`` concatenated
        along dim 0 in their order (JAX's tiled ``all_gather``)."""
        n = self.size(axis)
        if self.alone(axis):
            return tensor
        src = tensor.contiguous()
        if self._host_staged("all_gather", src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group(axis))
        return torch.cat(parts).to(tensor.device)

    def all_reduce_max(self, value: int) -> int:
        """The largest of the ranks' integers."""
        t = torch.tensor([value], dtype=torch.int64, device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0,
                   axis: str | None = None) -> None:
        """Overwrite each tensor with that of the ``src``-th rank of
        ``axis`` (by default rank ``src`` of the world)."""
        if self.alone(axis):
            return
        root = self.global_rank(axis, src)
        for t in tensors:
            dist.broadcast(t, root, group=self.group(axis))

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


def initialize_distributed(device=None, *, dp: int = -1, tp: int = 1) -> DataParallel | None:
    """Join the process group torchrun describes and return this rank's
    place in the (dp, tp) mesh over it (``make_mesh``); None without a
    launcher (``WORLD_SIZE`` unset), where any ``tp`` or ``dp`` above 1
    raises. A group the caller already made is taken as it is. ``device``
    as ``resolve_device`` takes it: on CUDA the rank's device is
    ``LOCAL_RANK``."""
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if "WORLD_SIZE" not in os.environ:
            check_mesh(dp, tp, 1)
            return None
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT)
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(DataParallel(dist.get_rank(), dist.get_world_size(), device), dp, tp)


def make_mesh(world: DataParallel, dp: int = -1, tp: int = 1) -> DataParallel:
    """The (dp, tp) mesh over ``world``'s ranks (``dp`` -1: world / tp):
    global rank d * tp + t is row d, column t. Every rank must call it, in
    the same order as the others: it creates each row's tp group and each
    column's dp group (none where an axis is the whole world)."""
    if world.tp_size != 1:
        raise ValueError("make_mesh lays a mesh over the world's ranks, not over a mesh")
    check_mesh(dp, tp, world.world)
    if tp == 1:
        return world
    dp = world.world // tp
    mesh = DataParallel(world.rank, world.world, world.device, tp_size=tp)
    if dp == 1:
        return mesh             # the tp axis is the world, the dp axis one rank
    rows = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    cols = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    return dataclasses.replace(mesh, tp_group=rows[mesh.dp_index],
                               dp_group=cols[mesh.tp_index])


def warmup_collectives(dp: DataParallel | None) -> None:
    """A barrier and one small all-reduce, so the group's connections are
    made before the first step."""
    if dp is None:
        return
    dp.barrier()
    dp.all_reduce_max(0)


def check_mesh(dp: int, tp: int, world: int) -> None:
    """Raise unless a (dp, tp) mesh fits ``world`` ranks: ``tp`` divides the
    world and ``dp`` is -1 (world / tp) or world / tp. A plain run (no
    launcher) has world 1, so any axis above 1 names the launch it needs."""
    if tp < 1 or dp == 0 or dp < -1:
        raise ValueError(f"mesh (dp {dp}, tp {tp}): dp is -1 or positive, tp positive")
    need = tp * (1 if dp == -1 else dp)
    if world % tp or (dp != -1 and need != world):
        if dp == -1:
            what = f"mesh_tp={tp} does not divide the world size {world}"
        else:
            what = f"mesh_dp={dp} x mesh_tp={tp} = {need} ranks but the world size is {world}"
        raise ValueError(
            f"{what}: launch one process a device with `torchrun --nproc-per-node "
            f"{need}`, or pass mesh_dp -1 with a mesh_tp that divides the world")
