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

Tensor parallel (``LlamaModel(..., mesh=)``, a mesh whose tp axis is above
1): each tp rank holds its slices of the weights in ``qa/sharding.py``'s
Megatron layout (its H / tp query heads and their key / value heads, I / tp
of the MLP, V / tp of the vocabulary) and the activations between blocks
are replicated. Two autograd functions carry the collectives:
``copy_to_tp`` (identity forward, all-reduce backward) at the input of
each column-parallel product (q / k / v and gate / up, the LoRA adapters'
rank-r products, the LM head) and ``reduce_from_tp`` (all-reduce forward,
identity backward) at each row-parallel output (o, down) and after the
vocab-parallel embedding's masked lookup. ``full_logits`` gathers the
vocab shards; the finetune loss reduces over them without gathering.
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
from medtok_tpu_torch.qa import sharding


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


class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient over tp."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone(), "tp"), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone(), "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The tp ranks' last-dim slices concatenated forward; backward takes
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        parts = mesh.all_gather(x.movedim(-1, 0).contiguous(), axis="tp")
        return parts.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        t, w = ctx.mesh.tp_index, ctx.width
        return g[..., t * w:(t + 1) * w], None


def copy_to_tp(x, mesh):
    return x if mesh is None else _CopyToTP.apply(x, mesh)


def reduce_from_tp(x, mesh):
    return x if mesh is None else _ReduceFromTP.apply(x, mesh)


def gather_from_tp(x, mesh):
    return x if mesh is None else _GatherFromTP.apply(x, mesh)


def tp_mesh(mesh):
    """``mesh`` when its tp axis is above 1, else None (one device's code)."""
    return mesh if mesh is not None and mesh.tp_size > 1 else None


class LoraDense(nn.Module):
    """W x + (alpha/r) * (x A) B. The base projection is ``base`` (an
    ``nn.Linear``, weight [out, in]); the adapters keep the flax layout,
    ``lora_a`` [in, r] and ``lora_b`` [r, out], in fp32 whatever the base
    dtype, and are cast to the input's dtype as the JAX module casts
    them.

    Tensor parallel (``mesh``): a ``column`` projection holds out / tp
    outputs (``features`` is the local count) and takes the replicated x;
    its base product reads ``copy_to_tp(x)`` (or the caller's ``x_in``,
    shared by q / k / v) and its LoRA term ``copy_to_tp(x A) B``, so the
    rank-r product's gradient is summed over tp and ``lora_a`` gets its
    whole gradient on every rank. A ``row`` projection holds in / tp inputs
    and returns the sum over tp of the partial products; its LoRA term runs
    on the gathered input (``lora_a`` and ``lora_b`` replicated)."""

    def __init__(self, in_features: int, features: int, rank: int = 0, alpha: float = 32.0,
                 *, dtype=None, device=None, mesh=None, parallel: str | None = None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.mesh, self.parallel = tp_mesh(mesh), parallel
        tp = 1 if self.mesh is None else self.mesh.tp_size
        lora_in = in_features * tp if parallel == "row" else in_features
        self.base = nn.Linear(in_features, features, bias=False, dtype=dtype, device=device)
        if rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(lora_in, rank, device=device))
            self.lora_b = nn.Parameter(torch.zeros(rank, features, device=device))

    def forward(self, x, x_in=None):
        mesh = self.mesh
        if self.parallel == "row" and mesh is not None:
            y = reduce_from_tp(self.base(x), mesh)
            if self.rank > 0:
                a, b = self.lora_a.to(x.dtype), self.lora_b.to(x.dtype)
                y = y + (self.alpha / self.rank) * ((gather_from_tp(x, mesh) @ a) @ b)
            return y
        y = self.base(copy_to_tp(x, mesh) if x_in is None else x_in)
        if self.rank > 0:
            a, b = self.lora_a.to(x.dtype), self.lora_b.to(x.dtype)
            y = y + (self.alpha / self.rank) * (copy_to_tp(x @ a, mesh) @ b)
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


def local_heads(cfg: LlamaConfig, mesh) -> tuple[int, int]:
    """(query heads, key / value heads) a rank holds: all of them on one
    device; H / tp and KV / tp (or the one shared head) on a tp mesh."""
    mesh = tp_mesh(mesh)
    if mesh is None:
        return cfg.num_heads, cfg.num_kv_heads
    tp = mesh.tp_size
    return cfg.num_heads // tp, max(cfg.num_kv_heads // tp, 1)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = tp_mesh(mesh)
        E = cfg.hidden_size
        Dh = E // cfg.num_heads
        self.heads, self.kv_heads = local_heads(cfg, mesh)

        def proj(name, n_in, n_out, parallel):
            rank = cfg.lora_rank if name in cfg.lora_targets else 0
            return LoraDense(n_in, n_out, rank, cfg.lora_alpha, dtype=dtype, device=device,
                             mesh=mesh, parallel=parallel)

        self.q_proj = proj("q_proj", E, self.heads * Dh, "column")
        self.k_proj = proj("k_proj", E, self.kv_heads * Dh, "column")
        self.v_proj = proj("v_proj", E, self.kv_heads * Dh, "column")
        self.o_proj = proj("o_proj", self.heads * Dh, E, "row")

    def forward(self, x, positions, mask, cache=None):
        """x [B, L, E]; mask bool [B, 1, L, T] (T = L without a cache);
        cache (k [B, T, KV, Dh], v, slot) is written in place at
        [slot, slot + L) and returned as the new cache. On a tp mesh H and
        KV are this rank's heads."""
        c = self.cfg
        H, KV = self.heads, self.kv_heads
        Dh = c.hidden_size // c.num_heads
        B, L, _ = x.shape
        xf = copy_to_tp(x, self.mesh)
        q = self.q_proj(x, xf).view(B, L, H, Dh)
        k = self.k_proj(x, xf).view(B, L, KV, Dh)
        v = self.v_proj(x, xf).view(B, L, KV, Dh)
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
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None, mesh=None):
        super().__init__()
        self.mesh = tp_mesh(mesh)
        E = cfg.hidden_size
        I = cfg.intermediate_size // (1 if self.mesh is None else self.mesh.tp_size)
        self.gate_proj = nn.Linear(E, I, bias=False, dtype=dtype, device=device)
        self.up_proj = nn.Linear(E, I, bias=False, dtype=dtype, device=device)
        self.down_proj = nn.Linear(I, E, bias=False, dtype=dtype, device=device)

    def forward(self, x):
        x = copy_to_tp(x, self.mesh)
        return reduce_from_tp(self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
                              self.mesh)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=None, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.input_layernorm = nn.Parameter(torch.ones(E, dtype=dtype, device=device))
        self.self_attn = LlamaAttention(cfg, dtype=dtype, device=device, mesh=mesh)
        self.post_attention_layernorm = nn.Parameter(torch.ones(E, dtype=dtype, device=device))
        self.mlp = LlamaMLP(cfg, dtype=dtype, device=device, mesh=mesh)

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
    (``torch.utils.checkpoint``, non-reentrant) when autograd records.

    ``mesh``: a (dp, tp) mesh (``parallel.mesh.DataParallel``) whose tp
    axis splits the model (``qa/sharding.py``; ``check_divisibility`` must
    hold), or None. The embedding table and the LM head then hold this
    rank's V / tp vocabulary rows [vocab_start, vocab_start + V / tp)."""

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = tp_mesh(mesh)
        tp = 1 if self.mesh is None else self.mesh.tp_size
        if tp > 1:
            sharding.check_divisibility(cfg, tp)
        self.vocab_local = cfg.vocab_size // tp
        self.vocab_start = 0 if tp == 1 else self.mesh.tp_index * self.vocab_local
        self.kv_heads = local_heads(cfg, mesh)[1]
        self.embed_tokens = nn.Embedding(self.vocab_local, cfg.hidden_size, dtype=dtype,
                                         device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", LlamaLayer(cfg, dtype=dtype, device=device,
                                                      mesh=mesh))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size, dtype=dtype, device=device))
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, self.vocab_local, bias=False,
                                     dtype=dtype, device=device)

    def layers(self) -> list[LlamaLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def embed(self, input_ids):
        """Token embeddings; on a tp mesh each rank looks up the ids of its
        vocabulary rows (zeros for the others) and the ranks' rows are
        summed, which is exact: one rank holds each id."""
        if self.mesh is None:
            return self.embed_tokens(input_ids)
        local = input_ids - self.vocab_start
        mine = (local >= 0) & (local < self.vocab_local)
        rows = self.embed_tokens(local.clamp(0, self.vocab_local - 1))
        return reduce_from_tp(torch.where(mine[..., None], rows, 0.0), self.mesh)

    def apply_lm_head(self, x):
        """Vocab projection of any [..., E] tensor (the finetune loss applies
        it to the label window only); on a tp mesh this rank's V / tp
        logits."""
        x = copy_to_tp(x, self.mesh)
        if self.cfg.tie_word_embeddings:
            return x @ self.embed_tokens.weight.T
        return self.lm_head(x)

    def full_logits(self, x):
        """``apply_lm_head`` with the vocab shards gathered: [..., V]."""
        return gather_from_tp(self.apply_lm_head(x), self.mesh)

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


def _init_tensor_(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "lora_a":
        p.normal_(0.0, 0.02, generator=generator)
    elif leaf == "lora_b":
        p.zero_()
    elif p.dim() == 1:
        p.fill_(1.0)
    else:
        p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)


@torch.no_grad()
def init_llama_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` in the JAX model's initializer
    families: N(0, 1/fan_in) for projections and the embedding table (flax
    ``Dense`` / ``Embed``), N(0, 0.02) for ``lora_a``, zeros for ``lora_b``,
    ones for the RMSNorm weights. A tp-split ``LlamaModel`` draws each
    one-device tensor in the one-device order (one at a time, on its
    device) and keeps its slice, so every rank holds its part of the
    one-device model the same generator would draw."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        for name, p in model.named_parameters():
            _init_tensor_(name, p, generator)
        return model
    full = LlamaModel(model.cfg, device="meta")
    params = dict(model.named_parameters())
    for name, meta in full.named_parameters():
        p = params[name]
        t = torch.empty(meta.shape, dtype=p.dtype, device=p.device)
        _init_tensor_(name, t, generator)
        p.copy_(sharding.local_slice(name, t, model.cfg, mesh.tp_size, mesh.tp_index))
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
    then the result holds only the steps run (the JAX streaming route).

    On a tp mesh (the model's) every tp rank of a block calls it with the
    same prompts: the cache holds this rank's key / value heads, the last
    position's logits are gathered over tp, and tp rank 0's token is
    broadcast to the others, so the ranks never diverge."""
    dev = resolve_device(device)
    inputs_embeds, attention_mask = inputs_embeds.to(dev), attention_mask.to(dev)
    B, L, _ = inputs_embeds.shape
    total = L + max_new_tokens
    cfg = model.cfg
    Dh = cfg.hidden_size // cfg.num_heads
    caches = [tuple(torch.zeros(B, total, model.kv_heads, Dh, dtype=inputs_embeds.dtype,
                                device=dev) for _ in range(2))
              for _ in range(cfg.num_layers)]
    full_mask = torch.cat([attention_mask.long(),
                           torch.zeros(B, max_new_tokens, dtype=torch.long, device=dev)], dim=1)
    positions = torch.clamp(torch.cumsum(attention_mask.long(), dim=1) - 1, min=0)

    def last_logits(embeds, pos, slot):
        hidden, _ = model(inputs_embeds=embeds, attention_mask=full_mask, positions=pos,
                          caches=caches, cache_pos=slot, return_hidden=True)
        return model.full_logits(hidden[:, -1])

    last = last_logits(inputs_embeds, positions, 0)
    cur_pos = positions[:, -1]
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for i in range(max_new_tokens):
        tok = sample(last, temperature, top_p, generator)
        if model.mesh is not None:
            model.mesh.broadcast_([tok], src=0, axis="tp")
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

