"""EHR outcome model (counterpart of ``medtok_tpu/ehr/model.py``).

Frozen MedTok embedding table plus a learned miss row, projector 256 ->
input_dim, sinusoidal positional encoding + year embedding + day/hour
sin-cos time features gathered per code by visit id, [CLS, gender,
ethnicity] prepended, N post-norm ReLU transformer encoder layers with a
key-padding mask, CLS -> fc -> classify. Module names follow flax
(``layer_0``, ``self_attn``, ``norm1``, ``linear1``, ...), so ``convert.py``
carries a JAX parameter tree over one to one.

Training mode is ``module.train()``; every dropout draws from the
``generator`` passed to ``forward``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from medtok_tpu_torch.ehr.dataset import EHRBatch
from medtok_tpu_torch.models.layers import MultiheadAttention, dropout


class PositionalEncoding(nn.Module):
    """pe[pos] sinusoid + year embedding + day/hour sin-cos."""

    def __init__(self, d_model: int, dropout: float = 0.2, max_len: int = 2001,
                 max_year: int = 1000):
        super().__init__()
        position = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = np.zeros((max_len, d_model), np.float32)
        pe[:, 0::2] = np.sin(position * div)
        pe[:, 1::2] = np.cos(position * div)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        self.year_emb = nn.Embedding(max_year, d_model - 4)
        self.dropout = dropout

    def _time_embedding(self, t):
        year, day, hour = t[..., 0], t[..., 1], t[..., 2]
        two_pi = 2 * math.pi
        return torch.cat([
            self.year_emb(year),
            torch.sin(two_pi * day / 365)[..., None],
            torch.cos(two_pi * day / 365)[..., None],
            torch.sin(two_pi * hour / 24)[..., None],
            torch.cos(two_pi * hour / 24)[..., None],
        ], dim=-1)

    def forward(self, x, time_within, time_between, *, generator=None):
        x = x + self.pe[: x.shape[1]][None] \
            + self._time_embedding(time_within) \
            + self._time_embedding(time_between)
        return dropout(x, self.dropout if self.training else 0.0, generator)


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer semantics (post-norm, ReLU)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.5, *, use_flash: bool | str = False,
                 flash_precision: str = "highest"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout,
                                            use_flash=use_flash,
                                            flash_precision=flash_precision)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, pad_mask, *, generator=None):
        rate = self.dropout if self.training else 0.0
        attn = self.self_attn(x, x, x, ~pad_mask, generator=generator)
        x = self.norm1(x + dropout(attn, rate, generator))
        h = dropout(torch.relu(self.linear1(x)), rate, generator)
        h = dropout(self.linear2(h), rate, generator)
        return self.norm2(x + h)


class EHRModel(nn.Module):
    """num_class logits from an ``EHRBatch`` of tensors (``to_device``).
    ``embedding_table`` is the frozen MedTok export [vocab, 256]: a
    non-persistent buffer, not a parameter."""

    def __init__(self, embedding_table, num_class: int, *, input_dim: int = 64,
                 output_dim: int = 64, num_heads: int = 4, hidden_dim: int = 256,
                 num_layers: int = 4, dropout: float = 0.5, max_year: int = 1000,
                 use_flash: bool | str = False, flash_precision: str = "highest",
                 pe_dropout: float = 0.2):
        super().__init__()
        table = torch.as_tensor(np.asarray(embedding_table), dtype=torch.float32)
        emb_dim = table.shape[1]
        self.num_layers = num_layers
        self.register_buffer("embedding_table", table, persistent=False)
        self.miss_emb = nn.Parameter(torch.zeros(1, emb_dim))
        self.cls_emb = nn.Parameter(torch.zeros(1, output_dim))
        self.gender_emb = nn.Embedding(5, input_dim)
        self.ethnicity_emb = nn.Embedding(100, input_dim)
        self.projector = nn.Linear(emb_dim, input_dim)
        self.position_encoder = PositionalEncoding(output_dim, pe_dropout,
                                                   max_year=max_year)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                input_dim, num_heads, hidden_dim, dropout, use_flash=use_flash,
                flash_precision=flash_precision))
        self.fc = nn.Linear(output_dim, output_dim)
        self.classify = nn.Linear(output_dim, num_class)

    def patient_encoder(self, batch: EHRBatch, *, generator=None):
        # row `vocab` is the learned miss row. The JAX model gathers from
        # the table with that row appended; here the frozen rows are
        # gathered without a gradient and the miss row is put in by a
        # select, so the backward reduces into miss_emb alone instead of
        # scattering into a gradient of the whole table.
        vocab = self.embedding_table.shape[0]
        miss = (batch.codes == vocab)[..., None]
        src = self.embedding_table[batch.codes.clamp(max=vocab - 1)]
        src = self.projector(torch.where(miss, self.miss_emb, src))  # [B, C, input_dim]
        # per-code time features gathered by visit id
        vid = batch.visit_ids[..., None].expand(-1, -1, 3)
        tw = torch.gather(batch.time_within, 1, vid)
        tb = torch.gather(batch.time_between, 1, vid)
        src = self.position_encoder(src, tw, tb, generator=generator)

        B = src.shape[0]
        cls = self.cls_emb[None].expand(B, 1, -1)
        gender = self.gender_emb(batch.gender)[:, None, :]
        eth = self.ethnicity_emb(batch.ethnicity)[:, None, :]
        x = torch.cat([cls, gender, eth, src], dim=1)          # [B, C+3, D]
        pad = torch.cat([torch.zeros(B, 3, dtype=torch.bool, device=x.device),
                         batch.pad_mask], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, pad, generator=generator)
        return self.fc(x[:, 0, :])  # CLS

    def forward(self, batch: EHRBatch, *, generator=None):
        emb = self.patient_encoder(batch, generator=generator)
        return emb, self.classify(emb)


def to_device(batch: EHRBatch, device) -> EHRBatch:
    """A numpy ``EHRBatch`` as tensors on ``device``: indices int64, the
    padding mask bool, labels fp32; ``label_raw`` stays numpy (metrics
    only)."""
    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return EHRBatch(
        codes=idx(batch.codes), visit_ids=idx(batch.visit_ids),
        pad_mask=torch.from_numpy(np.asarray(batch.pad_mask, bool)).to(device),
        gender=idx(batch.gender), ethnicity=idx(batch.ethnicity),
        time_within=idx(batch.time_within), time_between=idx(batch.time_between),
        label_onehot=torch.from_numpy(np.asarray(batch.label_onehot, np.float32)).to(device),
        label_raw=np.asarray(batch.label_raw),
    )
