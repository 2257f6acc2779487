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
    raw parameters ``miss_emb``, ``cls_emb`` (the EHR model's learned
    embedding rows, declared with ``self.param``) -> unchanged

A ``.npz`` holds the same tree flattened with ``/``-joined keys
(``text_model/layer_0/attention/query/kernel``).

The whole flax variables dict ``{"params": ..., "usage": ...}`` also loads:
its ``usage`` collection (``quantize/codebook_used``,
``quantize/usage_counts``, int32) fills the quantizer's usage FIFO buffers.
Values are cast to each tensor's dtype, so one tree loads into the eval
model (parameters in the compute dtype) and into the training model (fp32
parameters) alike.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias", "codebook": "codebook",
           "miss_emb": "miss_emb", "cls_emb": "cls_emb"}


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
    of the same names (the quantizer's usage FIFO, int32)."""
    if not isinstance(params, Mapping):
        params = load_npz(params)
    usage = params.get("usage") if "params" in params else None
    model.load_state_dict(flax_params_to_state_dict(
        params["params"] if "params" in params else params), strict=True)
    for path, arr in flatten_tree(usage or {}).items():
        buf = model.get_buffer(path.replace("/", "."))
        buf.copy_(torch.from_numpy(np.array(arr)).to(buf.dtype))
    return model
