"""The Megatron layout of the QA LLM over the tp axis of a (dp, tp) mesh
(counterpart of ``medtok_tpu/qa/sharding.py``).

The JAX package annotates its parameter tree and lets XLA place the
collectives; the port gives each tp rank its slice of every large weight
and runs the collectives itself (``qa/llama.py``). Column-parallel in,
row-parallel out in every block, in ``nn.Linear``'s [out, in] layout:

- q / k / v projections: their output dim (heads) over tp, and so is the
  ``lora_b`` [r, out] of each;
- ``o_proj``: its input dim over tp (row-parallel: its partial outputs are
  summed over tp);
- MLP ``gate_proj`` / ``up_proj``: output dim over tp; ``down_proj``: input
  dim over tp;
- ``embed_tokens`` and ``lm_head``: the vocabulary over tp;
- ``lora_a``, ``o_proj``'s ``lora_b``, the norms and the soft-prompt
  projector: replicated.

Grouped-query attention: tp rank t holds query heads [t H/tp, (t+1) H/tp)
and the key / value heads they read. With KV % tp == 0 those are the
rank's own block of KV / tp heads; with tp % KV == 0 they are one head,
held by the tp / KV ranks whose query heads share it. Any other tp raises.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from medtok_tpu_torch.qa.llama import LlamaConfig

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def check_divisibility(cfg: LlamaConfig, tp: int) -> None:
    """Raise unless ``cfg`` splits over ``tp`` ranks: H % tp == 0, KV % tp
    == 0 or tp % KV == 0, and the intermediate and vocabulary sizes divide
    by tp."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    rules = [(H % tp == 0, f"num_heads {H} % tp == 0"),
             (KV % tp == 0 or tp % KV == 0, f"num_kv_heads {KV} % tp == 0 or tp % {KV} == 0"),
             (cfg.intermediate_size % tp == 0, f"intermediate_size {cfg.intermediate_size} "
                                               "% tp == 0"),
             (cfg.vocab_size % tp == 0, f"vocab_size {cfg.vocab_size} % tp == 0")]
    broken = [rule for ok, rule in rules if not ok]
    if broken:
        raise ValueError(f"the Llama config does not split over tp={tp}: the port needs "
                         + "; ".join(broken))


def kv_block(cfg: LlamaConfig, tp: int, t: int) -> tuple[int, int]:
    """(index, count) of the key / value head block that tp rank ``t``
    holds: its own of tp blocks when KV % tp == 0, else (tp % KV == 0) the
    one head its query heads read, of KV."""
    KV = cfg.num_kv_heads
    if KV % tp == 0:
        return t, tp
    return t // (tp // KV), KV


def param_spec(name: str) -> int | None:
    """The dim of the ``LlamaModel`` parameter ``name`` that is split over
    tp, or None when it is replicated (``llama_param_spec`` of the JAX
    module in the [out, in] layout)."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] in ("embed_tokens", "lm_head"):
        return 0
    if leaf == "lora_a":
        return None
    proj = next((p for p in parts if p in _COLUMN + _ROW), None)
    if proj is None:
        return None                       # norms
    if leaf == "lora_b":
        return None if proj in _ROW else 1
    return 0 if proj in _COLUMN else 1


def _blocks(name: str, cfg: LlamaConfig, tp: int, t: int) -> tuple[int, int]:
    """(index, count) of the block of the split dim that rank t holds."""
    if any(p in name.split(".") for p in ("k_proj", "v_proj")):
        return kv_block(cfg, tp, t)
    return t, tp


def local_slice(name: str, full: torch.Tensor, cfg: LlamaConfig, tp: int, t: int
                ) -> torch.Tensor:
    """Rank ``t``'s slice of the full (one-device) parameter ``name`` (a
    view; the tensor itself where it is replicated)."""
    dim = param_spec(name)
    if dim is None or tp == 1:
        return full
    i, n = _blocks(name, cfg, tp, t)
    return full.chunk(n, dim=dim)[i]


def shard_state_dict(state_dict: dict, cfg: LlamaConfig, tp: int, t: int) -> dict:
    """Rank ``t``'s slices of a one-device ``LlamaModel`` state_dict."""
    return {k: local_slice(k, v, cfg, tp, t) for k, v in state_dict.items()}


def gather_param(name: str, local: torch.Tensor, mesh, cfg: LlamaConfig) -> torch.Tensor:
    """The full (one-device) parameter from the tp ranks' slices of it
    (every rank of the tp axis calls it): all-gathered over tp and, where
    ranks share a key / value head, each head taken once."""
    dim = param_spec(name)
    if dim is None or mesh is None or mesh.tp_size == 1:
        return local
    tp = mesh.tp_size
    parts = mesh.all_gather(local.transpose(0, dim).contiguous(), axis="tp")
    parts = parts.chunk(tp)
    i_of = [_blocks(name, cfg, tp, r) for r in range(tp)]
    n = i_of[0][1]
    first = [next(r for r in range(tp) if i_of[r][0] == i) for i in range(n)]
    return torch.cat([parts[r] for r in first]).transpose(0, dim).contiguous()


def reduce_shared_kv_grads_(model, mesh) -> None:
    """Sum the gradient of each key / value ``lora_b`` slice over the tp
    ranks that share its head (tp % KV == 0, tp above KV): each of them
    holds the part of it that its own query heads give. One all-reduce over
    tp a tensor, each rank's slice placed at its head in a zero buffer."""
    cfg = model.cfg
    tp = mesh.tp_size
    if tp <= cfg.num_kv_heads:
        return
    i, n = kv_block(cfg, tp, mesh.tp_index)
    for name, p in model.named_parameters():
        if p.grad is None or param_spec(name) is None or not any(
                k in name.split(".") for k in ("k_proj", "v_proj")):
            continue
        dim = param_spec(name)
        buf = torch.zeros([s * n if d == dim else s for d, s in enumerate(p.shape)],
                          dtype=p.grad.dtype, device=p.grad.device)
        buf.narrow(dim, i * p.shape[dim], p.shape[dim]).copy_(p.grad)
        mesh.all_reduce_(buf, "tp")
        p.grad.copy_(buf.narrow(dim, i * p.shape[dim], p.shape[dim]))
