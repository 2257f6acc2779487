"""Weight bridge from the JAX package's parameters to the port's
``state_dict``.

The JAX model's flax ``params`` tree, given as a nested dict of numpy
arrays, maps onto the port's modules name for name (the port keeps the flax
module names), with these leaf renames:

    Dense ``kernel`` [in, out]  -> ``weight`` = kernel.T  (also the head-layout
                                  projections, whose kernel is [E, H*Dh])
    LayerNorm ``scale``         -> ``weight``
    Embed ``embedding``         -> ``weight``
    ``bias``, ``codebook``      -> unchanged
    the GAT convs' attention vectors ``att_src``, ``att_dst`` [H, C] -> unchanged
    raw parameters ``miss_emb``, ``cls_emb`` (the EHR model's learned
    embedding rows, declared with ``self.param``) -> unchanged
    the QA Llama's raw parameters ``input_layernorm``,
    ``post_attention_layernorm``, ``norm`` -> unchanged
    its LoRA adapters ``lora_a`` [in, r], ``lora_b`` [r, out] -> unchanged
    (the port keeps the flax layout: ``x @ lora_a @ lora_b``)
    the DeepSeek-V2 encoder's stacked experts ``gate_up_proj`` [n, 2I, E],
    ``down_proj`` [n, E, I] -> unchanged (its RMSNorms' ``scale`` -> ``weight``)

So ``layers_0/self_attn/q_proj/base/kernel`` becomes
``layers_0.self_attn.q_proj.base.weight`` (transposed). The QA tree
``{"llm": ..., "soft_prompt": ...}`` loads with ``load_qa_params``.

A ``.npz`` holds the same tree flattened with ``/``-joined keys
(``text_model/layer_0/attention/query/kernel``).

The whole flax variables dict ``{"params": ..., "usage": ...}`` also loads:
its ``usage`` collection (``quantize/codebook_used``,
``quantize/usage_counts``, int32) fills the quantizer's usage FIFO buffers,
and under ``use_kmeans`` its ``quantize/ema_codebook``, ``ema_cluster`` and
(with revival) ``ema_embed_prob`` fill the EMA codebook's buffers.
Values are cast to each tensor's dtype, so one tree loads into the eval
model (parameters in the compute dtype) and into the training model (fp32
parameters) alike.

A HuggingFace DeepSeek-V2 checkpoint's state_dict maps onto the
DeepSeek-V2 text encoder by ``convert_hf_deepseek_v2`` (names kept, the
routed experts stacked): ``model.text_model.load_state_dict`` takes it.

The stand-alone EMA quantizers' state (``ops/ema.py``: an
``EmbeddingEMAState``, a ``FeaturePoolState``, an ``embed_prob``) comes
across by ``ema_state_from_arrays``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias", "codebook": "codebook",
           "att_src": "att_src", "att_dst": "att_dst",
           "miss_emb": "miss_emb", "cls_emb": "cls_emb",
           "input_layernorm": "input_layernorm",
           "post_attention_layernorm": "post_attention_layernorm", "norm": "norm",
           "lora_a": "lora_a", "lora_b": "lora_b",
           "gate_up_proj": "gate_up_proj", "down_proj": "down_proj"}


def flatten_tree(tree: Mapping, sep: str = "/") -> dict[str, np.ndarray]:
    """Nested dict -> {joined path: array}."""
    out: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + [str(k)])
            else:
                out[sep.join(prefix + [str(k)])] = np.asarray(v)

    walk(tree, [])
    return out


def flax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` tree (nested dict of arrays) -> fp32 state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for path, arr in flatten_tree(params).items():
        *mods, leaf = path.split("/")
        if leaf not in _RENAME:
            raise KeyError(f"no port counterpart for parameter {path!r}")
        a = np.array(arr, np.float32)  # a writable copy
        if leaf == "kernel":
            a = np.ascontiguousarray(a.T)
        sd[".".join(mods + [_RENAME[leaf]])] = torch.from_numpy(a)
    return sd


def save_npz(params: Mapping, path: str | Path) -> None:
    """Write a flax ``params`` tree as a ``/``-keyed .npz."""
    np.savez(path, **flatten_tree(params))


def load_npz(path: str | Path) -> dict:
    """Read a ``/``-keyed .npz back into a nested dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return tree


def load_params(model: nn.Module, params: Mapping | str | Path) -> nn.Module:
    """Load a flax params tree, or a variables dict with ``params`` and
    ``usage``, or a .npz of either, into ``model``. Every parameter must be
    present and nothing may be left over; values are cast to each
    parameter's dtype. A ``usage`` collection is copied into the buffers
    of the same names (the quantizer's usage FIFO and EMA codebook), each
    of the buffer's shape."""
    if not isinstance(params, Mapping):
        params = load_npz(params)
    usage = params.get("usage") if "params" in params else None
    model.load_state_dict(flax_params_to_state_dict(
        params["params"] if "params" in params else params), strict=True)
    for path, arr in flatten_tree(usage or {}).items():
        buf = model.get_buffer(path.replace("/", "."))
        if tuple(buf.shape) != np.shape(arr):
            raise ValueError(f"usage {path!r}: shape {np.shape(arr)} != {tuple(buf.shape)}")
        buf.copy_(torch.from_numpy(np.array(arr)).to(buf.dtype))
    return model


def load_qa_params(llm: nn.Module, soft_prompt: nn.Module, tree: Mapping) -> None:
    """Load the JAX QA finetuner's params tree ``{"llm": ..., "soft_prompt":
    ...}`` (nested dicts of arrays) into the port's ``LlamaModel`` and
    ``MedTokSoftPrompt``, every parameter present on both sides."""
    load_params(llm, tree["llm"])
    load_params(soft_prompt, tree["soft_prompt"])


def ema_state_from_arrays(state, device=None):
    """The JAX EMA quantizers' state as the port's: an ``EmbeddingEMAState``
    or ``FeaturePoolState`` (any NamedTuple with those fields, holding numpy
    arrays or anything ``np.asarray`` takes) becomes the port's NamedTuple of
    tensors of the same dtypes; one array (an ``embed_prob`` or a
    ``cluster_size`` buffer) becomes one tensor."""
    from medtok_tpu_torch.ops.ema import EmbeddingEMAState, FeaturePoolState

    def tensor(x):
        return torch.from_numpy(np.array(x)).to(device)

    fields = getattr(state, "_fields", None)
    if fields is None:
        return tensor(state)
    for cls in (EmbeddingEMAState, FeaturePoolState):
        if tuple(fields) == cls._fields:
            return cls(*(tensor(x) for x in state))
    raise ValueError(f"no EMA state of the port has the fields {fields}")


def convert_hf_deepseek_v2(state_dict, cfg) -> dict[str, torch.Tensor]:
    """A HuggingFace ``DeepseekV2Model`` (or ``ForCausalLM``) state_dict
    (tensors or numpy arrays; a ``model.`` prefix is dropped, ``lm_head``
    ignored) as the state_dict of ``DeepseekV2Encoder``: names kept but
    the routed experts', ``mlp.experts.{e}.gate_proj`` / ``up_proj`` /
    ``down_proj`` stacked into ``mlp.experts.gate_up_proj`` [n, 2I, E] and
    ``mlp.experts.down_proj`` [n, E, I]. Values come back as fp32
    tensors; every parameter of the encoder must be present."""

    def arr(key):
        for k in ("model." + key, key):
            if k in state_dict:
                v = state_dict[k]
                v = (v.detach().cpu() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.asarray(v)))
                return v.to(torch.float32)
        raise KeyError(f"no {key!r} in the DeepSeek-V2 state_dict")

    sd = {"embed_tokens.weight": arr("embed_tokens.weight"), "norm.weight": arr("norm.weight")}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names = ["input_layernorm.weight", "post_attention_layernorm.weight"]
        names += [f"self_attn.{m}.weight" for m in ("q_proj", "kv_a_proj_with_mqa",
                                                    "kv_a_layernorm", "kv_b_proj", "o_proj")]
        if i < cfg.first_k_dense_replace:
            names += [f"mlp.{m}.weight" for m in ("gate_proj", "up_proj", "down_proj")]
        else:
            names += ["mlp.gate.weight"] + [f"mlp.shared_experts.{m}.weight"
                                            for m in ("gate_proj", "up_proj", "down_proj")]
            e = range(cfg.n_routed_experts)
            sd[p + "mlp.experts.gate_up_proj"] = torch.stack([torch.cat(
                [arr(f"{p}mlp.experts.{j}.gate_proj.weight"),
                 arr(f"{p}mlp.experts.{j}.up_proj.weight")]) for j in e])
            sd[p + "mlp.experts.down_proj"] = torch.stack(
                [arr(f"{p}mlp.experts.{j}.down_proj.weight") for j in e])
        for name in names:
            sd[p + name] = arr(p + name)
    return sd
