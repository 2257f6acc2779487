"""A plain PyTorch DeepSeek-V2 text encoder, and MedTok with it in the BERT's
place: the benchmark's reference for the ``medtok-dsv2lite`` configuration,
written from the published model (DeepSeek-V2, arXiv:2405.04434; the HF
``modeling_deepseek.py`` equations of ``DeepseekV2Model`` in eval),
importing nothing of the port.

Per layer, on fp32 states x:

  a  = RMSNorm(x)
  q  = a Wq, per head [nope 128 | rope 64]
  c, k_rope = split(a Wkv_a, [512, 64]); kv = RMSNorm(c) Wkv_b, per head
       [k_nope 128 | v 128]; k_rope one row shared by every head
  RoPE on q_rope and k_rope: de-interleave (d/2 pairs (x0, x1) -> the
       evens, then the odds), then x cos + rotate_half(x) sin, at YaRN's
       inverse frequencies (base 1e4, factor 40, original 4096 positions,
       beta 32 / 1: pairs below the correction range at the base
       frequency, above it divided by the factor, a linear ramp between)
  softmax((q k^T) s) v, s = 192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2, causal
       (a key at or before the query, of the same code), Wo
  x  = x + that
  m  = RMSNorm(x); layer 0: SwiGLU 10,944; the rest: p = softmax(m Wg)
       over 64 experts, the 6 largest (not renormalised, times 1),
       sum_e p_e SwiGLU_e(m) (width 1,408) + SwiGLU_shared(m) (width 2,816)
  x  = x + that
  out = RMSNorm(x)   (eps 1e-6)

Everything runs in float32 (TF32 off), each code on its own row at
positions 0..n-1, the experts by a loop over them. The one departure from
the model: MedTok reads the first token's state ([CLS] of its BERT); a
causal encoder's first token sees only itself, so the code's feature is its
**last** token's state, moved to the front of the code's rows (the
cross-attention carries no positions, so nothing else changes). The rest
of MedTok is ``portbench/reference/medtok.py``'s, by import. Weights may be
held in bf16 (they are drawn in bf16, so exact): each layer's are cast to
fp32 as the layer runs. ``Precision("fp8")`` rounds every product's
operands to float8 e4m3 (the gate's, which the configuration states in
fp32, to TF32): the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.medtok import NEG_INF, MedTok, Precision, linear
from portbench.reference.medtok import param_spec as medtok_param_spec

TEXT = "text_model."


def text_param_spec(t: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, family) of the encoder's parameters, as the port's
    state_dict names them: "fan_in" N(0, 1/fan_in) by the last axis (the
    embedding table, every projection, each stacked expert), "one" the
    RMSNorm scales."""
    E, H = t["hidden_size"], t["num_heads"]
    dn, dr, dv, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"], \
        t["kv_lora_rank"]
    n, I = t["n_routed_experts"], t["moe_intermediate_size"]
    spec = [(TEXT + "embed_tokens.weight", (t["vocab_size"], E), "fan_in")]

    def mlp(p, width):
        return [(p + "gate_proj.weight", (width, E), "fan_in"),
                (p + "up_proj.weight", (width, E), "fan_in"),
                (p + "down_proj.weight", (E, width), "fan_in")]

    for i in range(t["num_layers"]):
        p = f"{TEXT}layers.{i}."
        spec += [(p + "input_layernorm.weight", (E,), "one"),
                 (p + "self_attn.q_proj.weight", (H * (dn + dr), E), "fan_in"),
                 (p + "self_attn.kv_a_proj_with_mqa.weight", (r + dr, E), "fan_in"),
                 (p + "self_attn.kv_a_layernorm.weight", (r,), "one"),
                 (p + "self_attn.kv_b_proj.weight", (H * (dn + dv), r), "fan_in"),
                 (p + "self_attn.o_proj.weight", (E, H * dv), "fan_in"),
                 (p + "post_attention_layernorm.weight", (E,), "one")]
        if i < t["first_k_dense_replace"]:
            spec += mlp(p + "mlp.", t["intermediate_size"])
        else:
            spec += [(p + "mlp.gate.weight", (n, E), "fan_in"),
                     (p + "mlp.experts.gate_up_proj", (n, 2 * I, E), "fan_in"),
                     (p + "mlp.experts.down_proj", (n, E, I), "fan_in")]
            spec += mlp(p + "mlp.shared_experts.", I * t["n_shared_experts"])
    spec.append((TEXT + "norm.weight", (E,), "one"))
    return spec


def param_spec(model_cfg: dict) -> list[tuple[str, tuple, str]]:
    """The encoder's parameters, then MedTok's tail as ``medtok.param_spec``
    gives it (``text_mapped``'s fan-in the encoder's width)."""
    stub = {"vocab_size": 0, "hidden_size": model_cfg["text"]["hidden_size"], "num_layers": 0,
            "intermediate_size": 0, "max_position_embeddings": 0, "type_vocab_size": 0}
    tail = [s for s in medtok_param_spec({**model_cfg, "text": stub})
            if not s[0].startswith(TEXT)]
    return text_param_spec(model_cfg["text"]) + tail


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1.0 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(t: dict) -> torch.Tensor:
    """YaRN's inverse frequencies [rope / 2], in float64 arithmetic."""
    dim, base, factor = t["qk_rope_head_dim"], t["rope_theta"], t["rope_factor"]
    old = t["rope_original_max_position"]
    freq = [base ** (-2.0 * j / dim) for j in range(dim // 2)]

    def corr(rotations):
        return dim * math.log(old / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(t["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(t["rope_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    out = []
    for j, f in enumerate(freq):
        ramp = min(max((j - low) / (high - low), 0.0), 1.0)     # 1: fully interpolated
        out.append(f / factor * ramp + f * (1.0 - ramp))
    return torch.tensor(out, dtype=torch.float64)


def rotate(x, cos, sin):
    """HF's RoPE on [..., L, d]: de-interleave, then rotate-half."""
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


class DeepseekV2:
    """The encoder's forward on a weights dict named as ``text_param_spec``."""

    def __init__(self, text_cfg: dict, weights: dict, prec: Precision | None = None):
        self.t, self.w = text_cfg, weights
        self.prec = prec or Precision("fp32")

    def W(self, name: str) -> torch.Tensor:
        return self.w[TEXT + name].float()

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Final states [B, L, E] of codes ``ids`` [B, L] (``mask``: their
        real tokens, a prefix; positions 0..L-1)."""
        t = self.t
        B, L = ids.shape
        dev = ids.device
        f = inv_freq(t).to(dev)
        ang = torch.arange(L, device=dev, dtype=torch.float64)[:, None] * f[None]
        ang = torch.cat([ang, ang], dim=-1)
        m = yarn_mscale(t["rope_factor"], t["rope_mscale"]) / yarn_mscale(
            t["rope_factor"], t["rope_mscale_all_dim"])
        cos, sin = (torch.cos(ang) * m).float(), (torch.sin(ang) * m).float()
        i = torch.arange(L, device=dev)
        # a key at or before the query, both real; a padding query sees itself
        visible = (i[:, None] >= i[None, :]) & mask[:, None, :] & mask[:, :, None]
        visible = visible | (i[:, None] == i[None, :])
        x = self.W("embed_tokens.weight")[ids]
        for n in range(t["num_layers"]):
            x = self.layer(n, x, cos, sin, visible)
        return rms_norm(x, self.W("norm.weight"), t["layer_norm_eps"])

    def layer(self, n, x, cos, sin, visible):
        t, pr = self.t, self.prec
        p = f"layers.{n}."
        B, L, E = x.shape
        H = t["num_heads"]
        dn, dr, dv, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"], \
            t["kv_lora_rank"]
        eps = t["layer_norm_eps"]
        a = rms_norm(x, self.W(p + "input_layernorm.weight"), eps)
        q = linear(a, self.W(p + "self_attn.q_proj.weight"), None, pr)
        q = q.view(B, L, H, dn + dr).transpose(1, 2)
        ckv = linear(a, self.W(p + "self_attn.kv_a_proj_with_mqa.weight"), None, pr)
        c, k_rope = ckv[..., :r], ckv[..., r:]
        kv = linear(rms_norm(c, self.W(p + "self_attn.kv_a_layernorm.weight"), eps),
                    self.W(p + "self_attn.kv_b_proj.weight"), None, pr)
        kv = kv.view(B, L, H, dn + dv).transpose(1, 2)
        q = torch.cat([q[..., :dn], rotate(q[..., dn:], cos, sin)], dim=-1)
        k_rope = rotate(k_rope[:, None], cos, sin).expand(B, H, L, dr)
        k = torch.cat([kv[..., :dn], k_rope], dim=-1)
        v = kv[..., dn:]
        s = (dn + dr) ** -0.5 * yarn_mscale(t["rope_factor"], t["rope_mscale_all_dim"]) ** 2
        logits = pr.gemm(q) @ pr.gemm(k).transpose(-1, -2) * s
        attn = torch.softmax(torch.where(visible[:, None], logits, NEG_INF), dim=-1)
        o = (pr.gemm(attn) @ pr.gemm(v)).transpose(1, 2).reshape(B, L, H * dv)
        x = x + linear(o, self.W(p + "self_attn.o_proj.weight"), None, pr)
        m = rms_norm(x, self.W(p + "post_attention_layernorm.weight"), eps)
        if n < t["first_k_dense_replace"]:
            return x + self.swiglu(m, p + "mlp.")
        return x + self.moe(m.reshape(B * L, E), p + "mlp.").view(B, L, E)

    def swiglu(self, x, p, w=None):
        pr = self.prec
        g, u, d = w or (self.W(p + "gate_proj.weight"), self.W(p + "up_proj.weight"),
                        self.W(p + "down_proj.weight"))
        return linear(F.silu(linear(x, g, None, pr)) * linear(x, u, None, pr), d, None, pr)

    def moe(self, x, p):
        """Routed experts by a loop over them, then the shared ones."""
        t, pr = self.t, self.prec
        n, I, k = t["n_routed_experts"], t["moe_intermediate_size"], t["num_experts_per_tok"]
        scores = torch.softmax(pr.dist(x) @ pr.dist(self.W(p + "gate.weight")).T, dim=-1)
        weight, idx = torch.topk(scores, k, dim=-1)
        if k > 1 and t["norm_topk_prob"]:
            weight = weight / weight.sum(-1, keepdim=True)
        else:
            weight = weight * t["routed_scaling_factor"]
        gate_up, down = self.W(p + "experts.gate_up_proj"), self.W(p + "experts.down_proj")
        out = torch.zeros_like(x)
        for e in range(n):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if len(tok):
                y = self.swiglu(x[tok], None, (gate_up[e, :I], gate_up[e, I:], down[e]))
                out.index_add_(0, tok, weight[tok, slot, None] * y)
        return out + self.swiglu(x, p + "shared_experts.")


def last_token_first(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each code's rows [B, L, E] with its last real token's moved to the
    front: n - 1, 0, 1, ..., n - 2, then the padding."""
    L = hidden.shape[1]
    n = mask.long().sum(1, keepdim=True)
    j = torch.arange(L, device=hidden.device)[None]
    src = torch.where(j < n, torch.where(j == 0, n - 1, j - 1), j).clamp(min=0)
    return hidden.gather(1, src[..., None].expand_as(hidden))


class MedTokDSV2(MedTok):
    """MedTok (``reference/medtok.py``) with the DeepSeek-V2 encoder in the
    BERT's place and its last token where MedTok reads the first."""

    _last = None        # (ids, mask, states) of the last call: eval_rows and
    #                       pooled_text of one batch run the encoder once

    def bert(self, ids: torch.Tensor, mask: torch.Tensor, rows: int = 256) -> torch.Tensor:
        if self._last is None or self._last[0] is not ids or self._last[1] is not mask:
            self._last = (ids, mask, last_token_first(self.states(ids, mask, rows), mask))
        return self._last[2]

    def states(self, ids: torch.Tensor, mask: torch.Tensor, rows: int = 256) -> torch.Tensor:
        """The encoder's final states [B, L, E], ``rows`` codes at a time."""
        enc = DeepseekV2(self.cfg["text"], self.w, self.prec)
        with torch.no_grad():
            return torch.cat([enc.forward(ids[i:i + rows], mask[i:i + rows])
                              for i in range(0, ids.shape[0], rows)])

    def pooled_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Each code's text feature [B, E]: its last real token's state."""
        return self.bert(ids, mask)[:, 0]
