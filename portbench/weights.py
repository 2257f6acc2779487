"""Seeded weights, made on the device in a few large calls and in the types
they are served in; the program and the reference both get them."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.medtok import is_trainable, param_spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, purpose: str) -> int:
    """An independent 63-bit seed for one use of a run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in purpose]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def served_dtype(name: str, model_cfg: dict, train: bool) -> torch.dtype:
    """The type a leaf is served in. Eval (the export): the encoders,
    text_mapped and the cross-attention in the compute dtype, the codebook
    and the specific projections in fp32. Training: fp32 everywhere but the
    frozen text encoder, which keeps the compute dtype."""
    compute = _DTYPES[model_cfg["compute_dtype"]]
    if name.startswith("text_model."):
        return compute
    if train or name == "quantize.codebook" or name.startswith("quantize.proj_"):
        return torch.float32
    return compute


def make_weights(model_cfg: dict, seed: int, device, *, train: bool) -> dict[str, torch.Tensor]:
    """Every parameter of ``param_spec`` from one normal draw on ``device``
    (scaled per family), cast once to its served type."""
    spec = param_spec(model_cfg)
    drawn = [(n, s, f) for n, s, f in spec if f in ("fan_in", "unit", "glorot")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, family in spec:
        dt = served_dtype(name, model_cfg, train)
        if family == "zero":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif family == "one":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        else:
            n = math.prod(shape)
            std = {"fan_in": 1.0 / math.sqrt(shape[-1]), "unit": 1.0,
                   "glorot": math.sqrt(2.0 / sum(shape))}[family]
            out[name] = (flat[at:at + n].view(shape) * std).to(dt)
            at += n
    return out


def load_into(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy the weights into the program's model; every name and type must
    match its state_dict (nothing is cast on the way)."""
    own = model.state_dict()
    if set(own) != set(weights):
        raise ValueError(f"weights and model differ in names: "
                         f"{sorted(set(own) ^ set(weights))[:8]}")
    wrong = [n for n in own
             if own[n].dtype != weights[n].dtype or own[n].shape != weights[n].shape]
    if wrong:
        raise ValueError(f"weights and model differ in type or shape at {wrong[:8]}")
    model.load_state_dict(weights, strict=True)


def reference_copy(weights: dict[str, torch.Tensor], *, trainable_grad: bool = False
                   ) -> dict[str, torch.Tensor]:
    """fp32 copies (exact: every served type widens to fp32) for the
    reference; trainable leaves optionally requiring gradients."""
    out = {}
    for name, w in weights.items():
        v = w.detach().float().clone()
        if trainable_grad and is_trainable(name):
            v.requires_grad_(True)
        out[name] = v
    return out
