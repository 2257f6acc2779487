"""The yardstick's arithmetic for a DeepSeek-V2 text encoder in MedTok
(``medtok-dsv2lite``): the model operations that codes of given true sizes
need, and the least time of the routed experts' products. Peaks are
``counts.py``'s (an H100 SXM's data sheet at 700 W)."""

from __future__ import annotations

import numpy as np

from portbench import counts


def encoder_flops_per_token(t: dict) -> float:
    """Operations (a multiply-add is two) of one token through the encoder's
    projections and its active experts, attention's products left out:
    every layer's MLA projections (q, the latent and its rope row, the
    latent's lift to keys and values, the output), the dense layers'
    SwiGLU, and in each MoE layer the gate, the k routed experts and the
    shared experts."""
    E, H = t["hidden_size"], t["num_heads"]
    dn, dr, dv, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"], \
        t["kv_lora_rank"]
    L, dense = t["num_layers"], t["first_k_dense_replace"]
    I, n, k = t["moe_intermediate_size"], t["n_routed_experts"], t["num_experts_per_tok"]
    mla = 2 * (E * H * (dn + dr) + E * (r + dr) + r * H * (dn + dv) + H * dv * E)
    swiglu = 2 * 3 * E * t["intermediate_size"]
    moe = 2 * E * n + (k + t["n_shared_experts"]) * 2 * 3 * E * I
    return float(L * mla + dense * swiglu + (L - dense) * moe)


def encoder_flops(t: dict, tokens) -> float:
    """The encoder over codes of ``tokens`` true tokens each: no padding;
    causal attention, query i of a code against its keys 0..i, QK^T at
    nope + rope and PV at v a head."""
    n = np.asarray(tokens, np.float64)
    pairs = n * (n + 1) / 2
    attn = t["num_layers"] * 2 * t["num_heads"] * (
        t["qk_nope_head_dim"] + t["qk_rope_head_dim"] + t["v_head_dim"]) * pairs
    return float(np.sum(n * encoder_flops_per_token(t) + attn))


def model_flops(model_cfg: dict, tokens, nodes, edges) -> float:
    """The export's operations: the encoder's, plus MedTok's tail exactly as
    ``counts.model_flops`` counts it (its BERT term zero, ``text_mapped``
    at the encoder's width)."""
    tail = dict(model_cfg, text=dict(model_cfg["text"], num_layers=0))
    return encoder_flops(model_cfg["text"], tokens) + counts.model_flops(
        tail, tokens, nodes, edges, train=False)


def experts_bound_s(t: dict, tokens_per_step) -> float:
    """The routed experts' least time over steps of these real tokens: in
    each MoE layer of a step the larger of the real token-expert pairs'
    three bf16 products (gate, up, down) at the bf16 peak and the stacked
    expert weights read once (bf16) at the memory rate."""
    E, I = t["hidden_size"], t["moe_intermediate_size"]
    moe_layers = t["num_layers"] - t["first_k_dense_replace"]
    weight_bytes = t["n_routed_experts"] * 3 * E * I * 2.0
    total = 0.0
    for n in tokens_per_step:
        ops = 2 * 3 * E * I * float(n) * t["num_experts_per_tok"]
        total += moe_layers * max(ops / counts.PEAK_BF16, weight_bytes / counts.PEAK_BYTES)
    return total
