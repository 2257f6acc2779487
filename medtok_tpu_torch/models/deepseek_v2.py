"""DeepSeek-V2 as MedTok's frozen, causal text encoder (the decoder stack of
HF ``modeling_deepseek.py``'s ``DeepseekV2Model``, in eval, without a KV
cache; DeepSeek-V2, arXiv:2405.04434).

  embed_tokens -> per layer: x + MLA(RMSNorm(x)), then
                  x + (SwiGLU or MoE)(RMSNorm(x)) -> RMSNorm

Multi-head latent attention, without a query LoRA: ``q_proj`` gives each
head a ``qk_nope`` part and a ``qk_rope`` part; ``kv_a_proj_with_mqa`` gives
the ``kv_lora_rank`` latent, which an RMSNorm and ``kv_b_proj`` lift to each
head's ``qk_nope`` key and ``v_head_dim`` value, and one ``qk_rope`` key row
that every head shares. RoPE turns the rope parts only: de-interleaved (HF's
``view(..., d / 2, 2).transpose``), then rotate-half, at the YaRN
frequencies (``yarn_inv_freq``), computed in fp32. The softmax scale is
(nope + rope)^-0.5 times YaRN's mscale squared (``softmax_scale``).
Attention is causal within each packed segment (``segments``) or each
code's row (``attention_mask``); a padding slot attends to itself alone,
so its state stays finite and reaches no real token.

Layers below ``first_k_dense_replace`` hold a dense SwiGLU; the others a
mixture of experts: the softmax gate in fp32, greedy top-k (with
``norm_topk_prob`` false the weights times ``routed_scaling_factor``), no
token dropped. The token-expert pairs are sorted by expert and the routed
SwiGLUs run as two grouped products over the experts' stacked weights from
offsets computed on the device (``grouped_mm``: no host sync inside a
layer); each token's k outputs are weighted and summed in fp32 and rounded
once, then the shared experts (one SwiGLU of width ``n_shared_experts`` x
``moe_intermediate_size``) are added. Every routed slot is computed,
padding included: the packed rows' shape is fixed.

The ``text.*`` ranges (``utils/profiling.py::span``) name the parts in a
trace; while a profiler runs each MoE layer adds its real tokens by expert
into the device counter ``moe.expert_load.<layer>``
(``profiling.device_count``; padding slots, which all route alike, are
left out).
``convert.py::convert_hf_deepseek_v2`` maps a HuggingFace state_dict onto
the encoder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from medtok_tpu_torch.config import DeepseekV2TextConfig
from medtok_tpu_torch.utils.profiling import count, device_count, device_counting, span


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1.0 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepseekV2TextConfig) -> torch.Tensor:
    """[rope / 2] fp32 inverse frequencies: pairs below YaRN's correction
    range keep the base frequency, pairs above it are divided by the
    factor, with a linear ramp between (HF's
    ``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base, factor = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor
    pairs = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** pairs)
    inter = 1.0 / (factor * base ** pairs)

    def corr(rotations: float) -> float:
        return (dim * math.log(cfg.rope_original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def softmax_scale(cfg: DeepseekV2TextConfig) -> float:
    """(nope + rope)^-0.5 x mscale(factor, mscale_all_dim)^2."""
    m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rope_cos_sin(pos: torch.Tensor, inv_freq: torch.Tensor, cfg: DeepseekV2TextConfig):
    """cos, sin [B, 1, L, rope] fp32 of positions ``pos`` [B, L]."""
    freqs = pos.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]
    m = (_yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF's rotation of [B, h, L, d] (de-interleave, rotate-half) in fp32,
    back in ``x``'s dtype."""
    *lead, d = x.shape
    y = x.float().reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat([-y[..., d // 2:], y[..., :d // 2]], dim=-1)
    return (y * cos + half * sin).to(x.dtype)


def causal_mask(L: int, device, *, segments=None, attention_mask=None) -> torch.Tensor:
    """[B, 1, L, L] bool: key j visible to query i where both lie in one
    segment (``segments`` [B, L], 0 = padding) or are both real tokens
    (``attention_mask`` [B, L], or an [B, L, L] pairwise mask), and
    j <= i; every slot sees itself."""
    i = torch.arange(L, device=device)
    tril = i[:, None] >= i[None, :]
    eye = i[:, None] == i[None, :]
    if segments is not None:
        same = (segments[:, :, None] == segments[:, None, :]) & (segments[:, :, None] > 0)
    elif attention_mask is not None and attention_mask.dim() == 3:
        same = attention_mask.bool()
    elif attention_mask is not None:
        m = attention_mask.bool()
        same = m[:, :, None] & m[:, None, :]
    else:
        same = torch.ones((1, L, L), dtype=torch.bool, device=device)
    return ((same & tril) | eye)[:, None]


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [N, K] grouped by expert (group e: rows offs[e - 1] to
    offs[e], offs int32 on the device) times each group's ``w[e]``
    [M, K] transposed -> [N, M], as one ``torch._grouped_mm``. It takes
    bf16 on CUDA (fp32 too on the CPU) and rows of a multiple of 16 bytes;
    other operands are refused here, not run another way."""
    if x.is_cuda and x.dtype != torch.bfloat16:
        raise ValueError(f"the routed experts' grouped products take bf16 on CUDA, not "
                         f"{x.dtype}: run the DeepSeek-V2 encoder with compute_dtype bfloat16")
    for width in (x.shape[-1], w.shape[1]):
        if width * x.element_size() % 16:
            raise ValueError(f"the routed experts' grouped products need rows of a multiple "
                             f"of 16 bytes: width {width} in {x.dtype}")
    return torch._grouped_mm(x, w.transpose(1, 2), offs=offs)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden: int, width: int, *, dtype=None, device=None):
        super().__init__()
        fk = {"dtype": dtype, "device": device, "bias": False}
        self.gate_proj = nn.Linear(hidden, width, **fk)
        self.up_proj = nn.Linear(hidden, width, **fk)
        self.down_proj = nn.Linear(width, hidden, **fk)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Attention(nn.Module):
    """Multi-head latent attention (no query LoRA)."""

    def __init__(self, cfg: DeepseekV2TextConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.hidden_size, cfg.num_heads
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        fk = {"dtype": dtype, "device": device, "bias": False}
        self.q_proj = nn.Linear(E, H * dq, **fk)
        self.kv_a_proj_with_mqa = nn.Linear(E, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **fk)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.layer_norm_eps, dtype=dtype,
                                      device=device)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank,
                                   H * (cfg.qk_nope_head_dim + cfg.v_head_dim), **fk)
        self.o_proj = nn.Linear(H * cfg.v_head_dim, E, **fk)
        self.scale = softmax_scale(cfg)

    def forward(self, x, cos, sin, mask):
        c = self.cfg
        B, L, _ = x.shape
        H, dn, dr, dv = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        q = self.q_proj(x).view(B, L, H, dn + dr).transpose(1, 2)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, dr], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(B, L, H, dn + dv).transpose(1, 2)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe.reshape(B, 1, L, dr), cos, sin)
        k = torch.cat([k_nope, k_pe.expand(B, H, L, dr)], dim=-1)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(B, L, H * dv))


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked: ``gate_up_proj`` [n, 2I,
    E] (each expert's gate rows, then its up rows) and ``down_proj`` [n, E,
    I]."""

    def __init__(self, n: int, hidden: int, width: int, *, dtype=None, device=None):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty((n, 2 * width, hidden), dtype=dtype,
                                                     device=device))
        self.down_proj = nn.Parameter(torch.empty((n, hidden, width), dtype=dtype,
                                                  device=device))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2TextConfig, index: int, *, dtype=None, device=None):
        super().__init__()
        self.cfg, self.index = cfg, index
        E, n = cfg.hidden_size, cfg.n_routed_experts
        self.gate = nn.Linear(E, n, bias=False, dtype=dtype, device=device)
        self.experts = Experts(n, E, cfg.moe_intermediate_size, dtype=dtype, device=device)
        self.shared_experts = MLP(E, cfg.moe_intermediate_size * cfg.n_shared_experts,
                                  dtype=dtype, device=device)

    def route(self, x: torch.Tensor):
        """(weights [N, k] fp32, expert ids [N, k]) of tokens ``x`` [N, E]."""
        c = self.cfg
        scores = torch.softmax(F.linear(x.float(), self.gate.weight.float()), dim=-1)
        weight, idx = torch.topk(scores, c.num_experts_per_tok, dim=-1)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            weight = weight * c.routed_scaling_factor
        return weight, idx

    def forward(self, x: torch.Tensor, real: torch.Tensor | None = None) -> torch.Tensor:
        """x [N, E] -> [N, E]; ``real`` [N] bool marks the real tokens (None:
        all), which alone the load counter counts."""
        c = self.cfg
        k, n = c.num_experts_per_tok, c.n_routed_experts
        with span("text.moe.gate"):
            weight, idx = self.route(x)
        with span("text.moe.dispatch"):
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            # a scatter, not bincount: bincount reads its size on the host
            load = torch.zeros(n, dtype=torch.int64, device=flat.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            offs = torch.cumsum(load, 0, dtype=torch.int32)
            xs = x[order // k]
            if device_counting():
                pairs = (torch.ones_like(flat) if real is None
                         else real.repeat_interleave(k).long())
                device_count(f"moe.expert_load.{self.index}",
                             torch.zeros_like(load).scatter_add_(0, flat, pairs))
        with span("text.moe.experts"):
            ex = self.experts
            gate, up = grouped_mm(xs, ex.gate_up_proj, offs).chunk(2, dim=-1)
            ys = grouped_mm(F.silu(gate) * up, ex.down_proj, offs)
        with span("text.moe.combine"):
            y = torch.empty_like(ys)
            y[order] = ys
            out = (y.view(-1, k, y.shape[-1]).float() * weight[..., None]).sum(1).to(x.dtype)
        with span("text.moe.shared"):
            return out + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2TextConfig, index: int, *, dtype=None, device=None):
        super().__init__()
        fk = {"dtype": dtype, "device": device}
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.self_attn = Attention(cfg, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size, **fk) if self.dense
                    else MoE(cfg, index, **fk))

    def forward(self, x, cos, sin, mask, real=None):
        with span("text.mla"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        if self.dense:
            with span("text.mlp"):
                return x + self.mlp(self.post_attention_layernorm(x))
        with span("text.moe.gate"):
            h = self.post_attention_layernorm(x)
        return x + self.mlp(h.reshape(-1, h.shape[-1]), real).view_as(x)


class DeepseekV2Encoder(nn.Module):
    """Returns the final RMSNorm's states [B, L, hidden]; the call of
    ``BertEncoder`` (``position_ids`` and ``segments`` for packed rows,
    ``attention_mask`` for padded ones), without dropout."""

    def __init__(self, cfg: DeepseekV2TextConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        fk = {"dtype": dtype, "device": device}
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, **fk) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg).to(device), persistent=False)

    def forward(self, input_ids, attention_mask=None, *, position_ids=None, segments=None,
                generator: torch.Generator | None = None, dropout: bool = False):
        if dropout:
            raise ValueError("the DeepSeek-V2 text encoder runs without dropout "
                             "(text_dropout_in_train is BERT's)")
        ids = input_ids.long()
        B, L = ids.shape
        if position_ids is None:
            position_ids = torch.arange(L, device=ids.device)[None].expand(B, L)
        mask = causal_mask(L, ids.device, segments=segments, attention_mask=attention_mask)
        cos, sin = rope_cos_sin(position_ids, self.inv_freq, self.cfg)
        real = real_tokens(segments, attention_mask)
        x = self.embed_tokens(ids)
        for layer in self.layers:
            x = layer(x, cos, sin, mask, real)
        return self.norm(x)


def real_tokens(segments=None, attention_mask=None) -> torch.Tensor | None:
    """[B * L] bool, the real token slots (``causal_mask``'s arguments),
    or None where every slot is real."""
    if segments is not None:
        return (segments > 0).reshape(-1)
    if attention_mask is not None and attention_mask.dim() == 3:
        return attention_mask.bool().diagonal(dim1=1, dim2=2).reshape(-1)
    if attention_mask is not None:
        return attention_mask.bool().reshape(-1)
    return None


def last_first(index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row of ``index`` [B, L] (a code's token slots, ``mask`` marking
    its real ones, a prefix) with its last real entry moved to the front:
    [n - 1, 0, 1, ..., n - 2, then the padding as it was]. A causal
    encoder's code feature is its last token; MedTok's tail reads the
    first row (the pooled text half of h, the shared text row), and its
    cross-attention holds no positions, so the tail reads the last token
    where it read BERT's [CLS]."""
    n = mask.long().sum(1, keepdim=True)
    j = torch.arange(index.shape[1], device=index.device)[None]
    src = torch.where(j < n, torch.where(j == 0, n - 1, j - 1), j).clamp(min=0)
    return index.gather(1, src)


def count_routed(cfg, real_tokens: int, slots: int) -> None:
    """The MoE counters of one encoder call over ``slots`` token slots,
    ``real_tokens`` of them real: ``moe.pairs`` / ``moe.pair_slots``, the
    token-expert pairs of real tokens and of all slots over the MoE
    layers (nothing for BERT)."""
    if not isinstance(cfg, DeepseekV2TextConfig):
        return
    per = cfg.num_experts_per_tok * (cfg.num_layers - cfg.first_k_dense_replace)
    count("moe.pairs", int(real_tokens) * per)
    count("moe.pair_slots", int(slots) * per)
