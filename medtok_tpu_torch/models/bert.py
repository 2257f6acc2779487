"""Frozen BERT text encoder (counterpart of ``medtok_tpu/models/bert.py``).

Post-LayerNorm bert-base with position ids supplied by the caller, so packed
rows give each segment its own positions 0..len-1. With segment ids the
attention is kernel K2 (block-diagonal, [B, NH, L, Dh] head layout); without
them it is the dense masked softmax with a -1e9 fill (the unpacked API path).
The projections are plain ``nn.Linear``. ``convert_hf_bert`` maps a
HuggingFace ``BertModel`` state_dict onto this encoder.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from medtok_tpu_torch.config import TextEncoderConfig
from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
from medtok_tpu_torch.ops.gelu import bert_gelu


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        fk = {"dtype": dtype, "device": device}
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size, **fk)

    def forward(self, x, mask, segments=None):
        """mask: [B, L] key mask or [B, L, L] pairwise mask; segments: [B, L]
        int32 packed-segment ids (0 = padding). Returns [B, NH, L, Dh]."""
        c = self.cfg
        B, L, _ = x.shape
        H = c.num_heads
        Dh = c.hidden_size // H

        def heads(lin):
            return lin(x).view(B, L, H, Dh).transpose(1, 2).contiguous()

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        if segments is not None and c.packed_flash:
            return packed_segment_attention(q, k, v, segments,
                                            sm_scale=1.0 / math.sqrt(Dh))
        if segments is not None:
            mask = (segments[:, :, None] == segments[:, None, :]) & (
                segments[:, :, None] > 0)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(Dh)
        pair = mask[:, None, :, :] if mask.dim() == 3 else mask[:, None, None, :]
        logits = torch.where(pair, logits, -1e9)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(attn, v)


class BertLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, *, dtype=None, device=None):
        super().__init__()
        fk = {"dtype": dtype, "device": device}
        E = cfg.hidden_size
        self.attention = BertSelfAttention(cfg, **fk)
        self.attention_output = nn.Linear(E, E, **fk)
        self.attention_ln = nn.LayerNorm(E, eps=cfg.layer_norm_eps, **fk)
        self.intermediate = nn.Linear(E, cfg.intermediate_size, **fk)
        self.output = nn.Linear(cfg.intermediate_size, E, **fk)
        self.output_ln = nn.LayerNorm(E, eps=cfg.layer_norm_eps, **fk)

    def forward(self, x, mask, segments=None):
        B, L, E = x.shape
        a = self.attention(x, mask, segments)          # [B, NH, L, Dh]
        a = self.attention_output(a.transpose(1, 2).reshape(B, L, E))
        x = self.attention_ln(x + a)
        h = self.output(bert_gelu(self.intermediate(x)))
        return self.output_ln(x + h)


class BertEncoder(nn.Module):
    """Returns last_hidden_state [B, L, hidden]."""

    def __init__(self, cfg: TextEncoderConfig, *, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        fk = {"dtype": dtype, "device": device}
        E = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E, **fk)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E, **fk)
        self.embeddings_ln = nn.LayerNorm(E, eps=cfg.layer_norm_eps, **fk)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, **fk))

    def forward(self, input_ids, attention_mask=None, *, position_ids=None,
                segments=None):
        """attention_mask [B, L] or [B, L, L]; position_ids [B, L] (packed rows
        pass within-segment offsets); segments [B, L] enables kernel K2, and
        attention_mask may then be None."""
        ids = input_ids.long()
        L = ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(L, device=ids.device)[None, :]
        x = (self.word_embeddings(ids)
             + self.position_embeddings(position_ids.long())
             + self.token_type_embeddings(torch.zeros_like(ids)))
        x = self.embeddings_ln(x)
        mask = attention_mask.bool() if attention_mask is not None else None
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, segments)
        return x


def convert_hf_bert(state_dict, cfg: TextEncoderConfig) -> dict[str, torch.Tensor]:
    """A HuggingFace ``BertModel`` state_dict (tensors or numpy arrays) as
    the state_dict of ``BertEncoder`` (counterpart of the JAX package's
    ``convert_hf_bert``, which also transposes the Dense kernels: both
    torch layouts here are [out, in], so nothing is transposed). Values
    come back as fp32 tensors; ``load_state_dict`` casts them to the
    encoder's dtype."""

    def arr(key):
        v = state_dict[key]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return v.to(torch.float32)

    sd = {"word_embeddings.weight": arr("embeddings.word_embeddings.weight"),
          "position_embeddings.weight": arr("embeddings.position_embeddings.weight"),
          "token_type_embeddings.weight": arr("embeddings.token_type_embeddings.weight"),
          "embeddings_ln.weight": arr("embeddings.LayerNorm.weight"),
          "embeddings_ln.bias": arr("embeddings.LayerNorm.bias")}
    for i in range(cfg.num_layers):
        hf = f"encoder.layer.{i}"
        for port, theirs in (("attention.query", "attention.self.query"),
                             ("attention.key", "attention.self.key"),
                             ("attention.value", "attention.self.value"),
                             ("attention_output", "attention.output.dense"),
                             ("attention_ln", "attention.output.LayerNorm"),
                             ("intermediate", "intermediate.dense"),
                             ("output", "output.dense"),
                             ("output_ln", "output.LayerNorm")):
            for leaf in ("weight", "bias"):
                sd[f"layer_{i}.{port}.{leaf}"] = arr(f"{hf}.{theirs}.{leaf}")
    return sd
