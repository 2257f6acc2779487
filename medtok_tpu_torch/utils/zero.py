"""ZeRO stages as placements over the data-parallel group (counterpart of
``medtok_tpu/utils/zero.py``).

The JAX version writes each ZeRO stage as sharding annotations over the
mesh's data axis and lets XLA insert the collectives. PyTorch's
counterpart of a ``NamedSharding``-placed ``jax.Array`` is a DTensor: a
leaf becomes ``distribute_tensor(t, mesh, [Shard(dim)])`` or ``[Replicate()]``
on a ``DeviceMesh`` over the dp group of ``parallel/mesh.py``'s
``DataParallel``, and DTensor's operators run the collectives:

  stage 0  parameters and optimizer state replicated      (plain DDP)
  stage 1  optimizer state sharded over dp                 (ZeRO-1)
  stage 2  as stage 1; the gradient feeding the sharded
           update reduce-scattered                         (ZeRO-2)
  stage 3  parameters sharded over dp too, gathered on use (ZeRO-3 / FSDP)

Each sharded leaf is split along its largest dim divisible by the dp size;
a leaf with none stays replicated (its gather would cost more than it
saves). ``create_zero_config`` keeps the reference's DeepSpeed config-dict
shape. As in the JAX package, no entry point calls ``apply_zero``: the
trainers replicate their state.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.distributed as dist


def create_zero_config(
    *,
    global_batch_size: int,
    gradient_accumulation_steps: int = 1,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    mixed_precision: str = "bf16",
    clip_grad: float | None = None,
    zero_stage: int = 0,
) -> dict:
    """A DeepSpeed-shaped config dict (optimizer / bf16 / gradient_clipping /
    zero_optimization), its ZeRO block written as sharding intent. fp16 is
    refused: bf16 needs no loss scaling."""
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if mixed_precision not in ("bf16", "fp32", "none"):
        raise ValueError(
            f"mixed_precision must be bf16/fp32/none, got {mixed_precision!r} "
            "(fp16 loss-scaling is not supported)"
        )
    cfg = {
        "train_batch_size": global_batch_size,
        "gradient_accumulation_steps": gradient_accumulation_steps,
        "optimizer": {
            "type": "Adam",
            "adam_w_mode": weight_decay > 0,
            "params": {
                "lr": lr,
                "weight_decay": weight_decay,
                "bias_correction": True,
                "betas": [beta1, beta2],
            },
        },
        "bf16": {"enabled": mixed_precision == "bf16"},
        "zero_optimization": {
            "stage": zero_stage,
            "shard_optimizer_state": zero_stage >= 1,
            "reduce_scatter_gradients": zero_stage >= 2,
            "shard_parameters": zero_stage >= 3,
        },
    }
    if clip_grad is not None:
        cfg["gradient_clipping"] = clip_grad
    return cfg


def dp_shard_spec(shape: tuple, n_shards: int) -> int | None:
    """The dim to shard a leaf of ``shape`` along over ``n_shards`` ranks:
    the largest dim divisible by ``n_shards`` (the first of equal ones), or
    None (replicated) when none divides."""
    divisible = [d for d in range(len(shape)) if shape[d] % n_shards == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda d: shape[d])


def _placement(dim: int | None):
    from torch.distributed.tensor import Replicate, Shard

    return Replicate() if dim is None else Shard(dim)


def _map(tree: Any, fn) -> Any:
    """``fn`` applied to every tensor leaf of nested mappings, lists and
    tuples; other leaves (a Python step count) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _plan_tree(tree: Any, n: int, shard: bool) -> Any:
    return _map(tree, lambda t: _placement(dp_shard_spec(tuple(t.shape), n) if shard
                                           else None))


def zero_plan(stage: int, dp, params: Mapping, opt_state: Mapping | None = None) -> dict:
    """The placement of every tensor leaf of ``params`` (a name -> tensor
    mapping, as a module's ``state_dict()``) and ``opt_state`` (an
    optimizer's per-parameter state, as ``Optimizer.state_dict()["state"]``,
    nested mappings of tensors) for a ZeRO stage over ``dp``'s dp axis
    (``dp.dp_size`` ranks): ``{"params": ..., "opt_state": ...}`` of the
    same structure (``opt_state`` left out when not given), each leaf
    ``Shard(dim)`` by ``dp_shard_spec`` or ``Replicate()``. Parameters are
    sharded from stage 3, optimizer state from stage 1."""
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"zero stage must be 0..3, got {stage}")
    n = dp.dp_size
    plan = {"params": _plan_tree(params, n, stage >= 3)}
    if opt_state is not None:
        plan["opt_state"] = _plan_tree(opt_state, n, stage >= 1)
    return plan


def dp_device_mesh(dp):
    """A one-dim ``DeviceMesh`` over ``dp``'s dp axis (the world when that
    axis is the world, else its column group) on the ranks' device type."""
    from torch.distributed.device_mesh import DeviceMesh

    if dp.dp_group is not None:
        group = dp.dp_group
    elif dp.dp_size == dp.world:
        group = dist.group.WORLD
    else:
        raise ValueError("the dp axis is one rank of a larger world: nothing to shard over")
    return DeviceMesh.from_group(group, dp.device.type, mesh_dim_names=("dp",))


def apply_zero(stage: int, dp, params: Mapping, opt_state: Mapping | None = None):
    """Every tensor leaf placed by ``zero_plan`` as a DTensor on
    ``dp_device_mesh(dp)``: each rank passes the same full tensors and keeps
    its shard, cut locally (no collective, as ``jax.device_put`` of a
    global value). Returns the params, or (params, opt_state), of the same
    structure."""
    plan = zero_plan(stage, dp, params, opt_state)
    mesh = dp_device_mesh(dp)

    def place(tree, placements):
        from torch.distributed.tensor import distribute_tensor

        if isinstance(tree, torch.Tensor):
            return distribute_tensor(tree.to(dp.device), mesh, [placements],
                                     src_data_rank=None)
        if isinstance(tree, Mapping):
            return {k: place(v, placements[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v, p) for v, p in zip(tree, placements))
        return tree

    out = place(params, plan["params"])
    if opt_state is None:
        return out
    return out, place(opt_state, plan["opt_state"])


def local_bytes(tree: Any) -> int:
    """The bytes of the tensor leaves of ``tree`` that this rank holds (a
    DTensor's local shard; a plain tensor whole)."""
    total = 0

    def count(t):
        nonlocal total
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
        return t

    _map(tree, count)
    return total
