"""Llama-family causal LM with LoRA, the QA finetuning backbone
(counterpart of ``medtok_tpu/qa/llama.py``).

RMSNorm in fp32, rotary embeddings in the HF rotate-half convention, GQA,
SwiGLU, optional LoRA on the attention projections, a HF state_dict
converter and a KV-cache ``generate`` (greedy, or temperature + top-p).
Attention is plain torch ops in the JAX model's order: the query-key
products and the softmax in fp32 (``preferred_element_type=float32``), the
-1e9 mask, the probabilities cast back to the activations' dtype before
P.V. The GQA repeat of the JAX model (``jnp.repeat`` of the key and value
heads) is taken by grouping the query heads instead: query head h reads
key/value head h // (H / KV) in both, and the products run per key/value
head over the rows of its H / KV query heads.

Module and parameter names follow the flax tree (``layers_{i}``,
``self_attn.q_proj.base``, ``input_layernorm``, ``norm``), so
``convert.load_params`` loads a flax Llama tree by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from medtok_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    # LoRA (0 = disabled)
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_targets: tuple[str, ...] = ("q_proj", "v_proj")
    # recompute each layer's activations in the backward pass: at 8B
    # (B=16, L=512, 32 layers) the saved activations would take about 96 GB
    remat: bool = False


LLAMA31_8B = LlamaConfig()
TINY_LLAMA = LlamaConfig(
    vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, max_position_embeddings=256,
)


class LoraDense(nn.Module):
    """W x + (alpha/r) * (x A) B. The base projection is ``base`` (an
    ``nn.Linear``, weight [out, in]); the adapters keep the flax layout,
    ``lora_a`` [in, r] and ``lora_b`` [r, out], in fp32 whatever the base
    dtype, and are cast to the input's dtype as the JAX module casts
    them."""

    def __init__(self, in_features: int, features: int, rank: int = 0, alpha: float = 32.0,
                 *, dtype=None, device=None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.base = nn.Linear(in_features, features, bias=False, dtype=dtype, device=device)
        if rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(in_features, rank, device=device))
            self.lora_b = nn.Parameter(torch.zeros(rank, features, device=device))

    def forward(self, x):
        y = self.base(x)
        if self.rank > 0:
            a, b = self.lora_a.to(x.dtype), self.lora_b.to(x.dtype)
            y = y + (self.alpha / self.rank) * ((x @ a) @ b)
        return y


def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope(q, k, positions, theta: float, head_dim: int):
    """Rotary embeddings (HF Llama convention: rotate_half); q, k [B, L, heads,
    Dh], positions [B, L]. The frequencies are float64 numpy cast to fp32, as
    the JAX model's are."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    inv_freq = torch.as_tensor(inv_freq, dtype=torch.float32, device=q.device)
    freqs = positions[..., None].float() * inv_freq  # [B, L, Dh/2]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    cos = torch.cat([cos, cos], dim=-1)
    sin = torch.cat([sin, sin], dim=-1)

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    q2 = q * cos.to(q.dtype) + rot(q) * sin.to(q.dtype)
    k2 = k * cos.to(k.dtype) + rot(k) * sin.to(k.dtype)
    return q2, k2


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, E = cfg.num_heads, cfg.num_kv_heads, cfg.hidden_size
        Dh = E // H

        def proj(name, n_in, n_out):
            rank = cfg.lora_rank if name in cfg.lora_targets else 0
            return LoraDense(n_in, n_out, rank, cfg.lora_alpha, dtype=dtype, device=device)

        self.q_proj = proj("q_proj", E, H * Dh)
        self.k_proj = proj("k_proj", E, KV * Dh)
        self.v_proj = proj("v_proj", E, KV * Dh)
        self.o_proj = proj("o_proj", H * Dh, E)

    def forward(self, x, positions, mask, cache=None):
        """x [B, L, E]; mask bool [B, 1, L, T] (T = L without a cache);
        cache (k [B, T, KV, Dh], v, slot) is written in place at
        [slot, slot + L) and returned as the new cache."""
        c = self.cfg
        H, KV = c.num_heads, c.num_kv_heads
        Dh = c.hidden_size // H
        B, L, _ = x.shape
        q = self.q_proj(x).view(B, L, H, Dh)
        k = self.k_proj(x).view(B, L, KV, Dh)
        v = self.v_proj(x).view(B, L, KV, Dh)
        q, k = rope(q, k, positions, c.rope_theta, Dh)

        new_cache = None
        if cache is not None:
            ck, cv, slot = cache
            ck[:, slot:slot + L] = k
            cv[:, slot:slot + L] = v
            k, v, new_cache = ck, cv, (ck, cv)

        # the query heads of one key/value head as rows of one product:
        # [B, KV, rep * L, Dh] against [B, KV, T, Dh] (no broadcast, so
        # the key and value heads are not expanded rep times)
        rep = H // KV
        T = k.shape[1]
        qg = q.float().view(B, L, KV, rep, Dh).permute(0, 2, 3, 1, 4).reshape(B, KV, rep * L, Dh)
        kg = k.float().permute(0, 2, 3, 1)                               # [B, KV, Dh, T]
        logits = (torch.matmul(qg, kg) / math.sqrt(Dh)).view(B, KV, rep, L, T)
        logits = torch.where(mask[:, :, None], logits, -1e9)
        attn = torch.softmax(logits, dim=-1).to(x.dtype).view(B, KV, rep * L, T)
        out = torch.matmul(attn, v.permute(0, 2, 1, 3))                 # [B, KV, rep * L, Dh]
        out = out.view(B, KV, rep, L, Dh).permute(0, 3, 1, 2, 4).reshape(B, L, H * Dh)
        return self.o_proj(out), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None):
        super().__init__()
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(E, I, bias=False, dtype=dtype, device=device)
        self.up_proj = nn.Linear(E, I, bias=False, dtype=dtype, device=device)
        self.down_proj = nn.Linear(I, E, bias=False, dtype=dtype, device=device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.input_layernorm = nn.Parameter(torch.ones(E, dtype=dtype, device=device))
        self.self_attn = LlamaAttention(cfg, dtype=dtype, device=device)
        self.post_attention_layernorm = nn.Parameter(torch.ones(E, dtype=dtype, device=device))
        self.mlp = LlamaMLP(cfg, dtype=dtype, device=device)

    def forward(self, x, positions, mask, cache=None):
        eps = self.cfg.rms_norm_eps
        h, new_cache = self.self_attn(rms_norm(x, self.input_layernorm, eps), positions,
                                      mask, cache)
        x = x + h
        x = x + self.mlp(rms_norm(x, self.post_attention_layernorm, eps))
        return x, new_cache


class LlamaModel(nn.Module):
    """Causal LM. ``forward`` takes ``input_ids`` or ``inputs_embeds`` (the
    soft-prompt path injects embeddings). The base weights are in ``dtype``
    (bf16 for the 8B layout), the LoRA adapters in fp32. With
    ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when autograd records."""

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                         device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", LlamaLayer(cfg, dtype=dtype, device=device))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size, dtype=dtype, device=device))
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype,
                                     device=device)

    def layers(self) -> list[LlamaLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def apply_lm_head(self, x):
        """Vocab projection of any [..., E] tensor (the finetune loss applies
        it to the label window only)."""
        if self.cfg.tie_word_embeddings:
            return x @ self.embed_tokens.weight.T
        return self.lm_head(x)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                positions=None, caches=None, cache_pos=None, return_hidden=False):
        """(logits, or the final hidden states with ``return_hidden``; the
        caches written, or None). ``caches``: per layer (k, v) of
        [B, T, KV, Dh], written in place at slots [cache_pos, cache_pos + L);
        ``attention_mask`` then covers all T slots and a query sees the keys
        at slots up to its own (causal over slots: under left padding the
        rope positions differ from the slots)."""
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens(input_ids)
        B, L, _ = x.shape
        dev = x.device
        if positions is None:
            positions = torch.arange(L, device=dev)[None].expand(B, L)
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.long, device=dev)
        keys = attention_mask[:, None, None, :].bool()

        if caches is None:
            causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
            mask = causal[None, None] & keys
            layer_caches = [None] * self.cfg.num_layers
        else:
            T = caches[0][0].shape[1]
            key_slot = torch.arange(T, device=dev)[None, None, None, :]
            query_slot = (cache_pos + torch.arange(L, device=dev))[None, None, :, None]
            mask = (key_slot <= query_slot) & keys
            layer_caches = [(k, v, cache_pos) for (k, v) in caches]

        remat = self.cfg.remat and torch.is_grad_enabled()
        new_caches = []
        for layer, cache in zip(self.layers(), layer_caches):
            if remat:
                x, nc = checkpoint(layer, x, positions, mask, cache, use_reentrant=False)
            else:
                x, nc = layer(x, positions, mask, cache)
            new_caches.append(nc)
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        out = x if return_hidden else self.apply_lm_head(x)
        return out, (new_caches if caches is not None else None)


@torch.no_grad()
def init_llama_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` in the JAX model's initializer
    families: N(0, 1/fan_in) for projections and the embedding table (flax
    ``Dense`` / ``Embed``), N(0, 0.02) for ``lora_a``, zeros for ``lora_b``,
    ones for the RMSNorm weights."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lora_a":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "lora_b":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
    return model


# ---------------------------------------------------------------------------
# HF PyTorch state_dict -> the port's state_dict
# ---------------------------------------------------------------------------

def convert_hf_llama(state_dict: dict, cfg: LlamaConfig, *, dtype=None) -> dict:
    """A HF Llama state_dict renamed to this module's names (no transposes:
    both keep ``nn.Linear``'s [out, in]). ``dtype=torch.bfloat16`` gives the
    8B production layout (16 GB of weights); by default the values are fp32
    copies, as the JAX converter makes them."""
    def arr(key):
        return state_dict[key].detach().to("cpu", dtype or torch.float32).clone()

    sd = {"embed_tokens.weight": arr("model.embed_tokens.weight"),
          "norm": arr("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = arr("lm_head.weight")
    for i in range(cfg.num_layers):
        hf, me = f"model.layers.{i}", f"layers_{i}"
        sd[f"{me}.input_layernorm"] = arr(f"{hf}.input_layernorm.weight")
        sd[f"{me}.post_attention_layernorm"] = arr(f"{hf}.post_attention_layernorm.weight")
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{me}.self_attn.{name}.base.weight"] = arr(f"{hf}.self_attn.{name}.weight")
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{me}.mlp.{name}.weight"] = arr(f"{hf}.mlp.{name}.weight")
    return sd


# ---------------------------------------------------------------------------
# Generation (greedy / temperature + top-p)
# ---------------------------------------------------------------------------

def top_p_filter(last, temperature: float, top_p: float):
    """(sorted_idx, filt): the vocabulary sorted by probability (stable,
    lowest id first on ties) and the nucleus-filtered, renormalized
    probabilities in that order, as the JAX ``sample`` computes them: a
    token is kept when the probability mass before it is below ``top_p``.
    Computed in fp32."""
    probs = torch.softmax(last.float() / temperature, dim=-1)
    sorted_p, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    filt = torch.where(cum - sorted_p < top_p, sorted_p, 0.0)
    return sorted_idx, filt / filt.sum(dim=-1, keepdim=True)


def sample(last, temperature: float, top_p: float, generator: torch.Generator | None):
    """Next tokens [B] from the last logits [B, V]: argmax (first maximum)
    at temperature 0, else a draw from the top-p nucleus by the Gumbel-max
    rule over log(filt + 1e-12), as ``jax.random.categorical`` draws (the
    draws themselves come from ``generator``)."""
    if temperature <= 0:
        return torch.argmax(last, dim=-1)
    sorted_idx, filt = top_p_filter(last, temperature, top_p)
    u = torch.rand(filt.shape, generator=generator, device=filt.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(torch.log(filt + 1e-12) + gumbel, dim=-1)
    return torch.gather(sorted_idx, 1, choice[:, None])[:, 0]


@torch.no_grad()
def generate(
    model: LlamaModel,
    inputs_embeds: torch.Tensor,     # [B, L, E] (soft-prompt prefill)
    attention_mask: torch.Tensor,    # [B, L]
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.4,
    top_p: float = 0.9,
    eos_token_id: int | None = None,
    generator: torch.Generator | None = None,
    on_token: Callable[[int], None] | None = None,
    device=None,
) -> np.ndarray:
    """Continuation ids [B, max_new_tokens] (int64 numpy), on ``device``
    (CUDA unless named; the model must be there already).

    The prompt is prefilled into a static cache of L + max_new_tokens slots,
    then each token is decoded by one cached forward step (an eager Python
    loop). Positions are cumsum(mask) - 1 clamped at 0, so left padding is
    allowed. With ``eos_token_id`` a finished row keeps emitting it and the
    loop stops once every row has finished; the remaining columns are eos.
    ``on_token(tok)`` is called each step with the first row's token, and
    then the result holds only the steps run (the JAX streaming route)."""
    dev = resolve_device(device)
    inputs_embeds, attention_mask = inputs_embeds.to(dev), attention_mask.to(dev)
    B, L, _ = inputs_embeds.shape
    total = L + max_new_tokens
    cfg = model.cfg
    Dh = cfg.hidden_size // cfg.num_heads
    caches = [tuple(torch.zeros(B, total, cfg.num_kv_heads, Dh, dtype=inputs_embeds.dtype,
                                device=dev) for _ in range(2))
              for _ in range(cfg.num_layers)]
    full_mask = torch.cat([attention_mask.long(),
                           torch.zeros(B, max_new_tokens, dtype=torch.long, device=dev)], dim=1)
    positions = torch.clamp(torch.cumsum(attention_mask.long(), dim=1) - 1, min=0)

    def last_logits(embeds, pos, slot):
        hidden, _ = model(inputs_embeds=embeds, attention_mask=full_mask, positions=pos,
                          caches=caches, cache_pos=slot, return_hidden=True)
        return model.apply_lm_head(hidden[:, -1])

    last = last_logits(inputs_embeds, positions, 0)
    cur_pos = positions[:, -1]
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for i in range(max_new_tokens):
        tok = sample(last, temperature, top_p, generator)
        if eos_token_id is not None:
            tok = torch.where(finished, eos_token_id, tok)
            finished = finished | (tok == eos_token_id)
        out.append(tok)
        if on_token is not None:
            on_token(int(tok[0]))
        if i + 1 == max_new_tokens or (eos_token_id is not None and bool(finished.all())):
            break
        cur_pos = cur_pos + 1
        slot = L + i
        full_mask[:, slot] = 1
        last = last_logits(model.embed(tok[:, None]), cur_pos[:, None], slot)
    toks = torch.stack(out, dim=1).cpu().numpy()
    if on_token is None and toks.shape[1] < max_new_tokens:
        pad = np.full((B, max_new_tokens - toks.shape[1]), eos_token_id, toks.dtype)
        toks = np.concatenate([toks, pad], axis=1)
    return toks

