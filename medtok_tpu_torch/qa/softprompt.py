"""MedTok soft-prompt injection for the QA LLM (counterpart of
``medtok_tpu/qa/softprompt.py``).

Each row's first ``cutoff_len`` slots hold MedTok vocabulary ids (padded
with attention 0); their rows of the frozen exported table are gathered,
L2-normalized, mean-pooled over the valid slots to one vector, projected to
the LLM width and placed before the text token embeddings. Each row is
then right-aligned into a [B, total_len] window, [prefix | valid text],
with its attention mask rebuilt and labels -100 everywhere else.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from medtok_tpu_torch.ops.vq import l2_normalize


class SoftPromptBatch(NamedTuple):
    inputs_embeds: torch.Tensor    # [B, total_len, E]
    attention_mask: torch.Tensor   # [B, total_len] int64
    labels: torch.Tensor           # [B, total_len] int64 (-100 = ignored)


class MedTokSoftPrompt(nn.Module):
    """``projector``: Linear(table width 256 -> LLM width), fp32. The frozen
    table [vocab (+ miss rows), 256] is an fp32 buffer outside the
    state_dict, as it is a module attribute (not a parameter) in flax."""

    def __init__(self, embeddings: np.ndarray, hidden_size: int, cutoff_len: int = 256, *,
                 device=None):
        super().__init__()
        self.cutoff_len = cutoff_len
        self.hidden_size = hidden_size
        table = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32)
        self.register_buffer("embeddings", table.to(device), persistent=False)
        self.projector = nn.Linear(table.shape[1], hidden_size, device=device)

    def forward(
        self,
        input_ids: torch.Tensor,        # [B, cutoff_len + Lt]
        attention_mask: torch.Tensor,   # [B, cutoff_len + Lt]
        labels: torch.Tensor | None,    # [B, Lt] or None
        embed_fn: Callable[[torch.Tensor], torch.Tensor],
        total_len: int = 512,
        pad_embed: torch.Tensor | None = None,   # [E] filler
    ) -> SoftPromptBatch:
        cl = self.cutoff_len
        B = input_ids.shape[0]
        table = self.embeddings

        med_ids = input_ids[:, :cl]
        med_mask = attention_mask[:, :cl].float()
        med = l2_normalize(table[med_ids.clamp(0, table.shape[0] - 1)])
        denom = med_mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        pooled = (med * med_mask[..., None]).sum(dim=1) / denom     # [B, 256]
        prefix = self.projector(pooled)[:, None, :]

        text_ids = input_ids[:, cl:]
        text_mask = attention_mask[:, cl:]
        text_embeds = embed_fn(text_ids)
        # the LLM's dtype: an fp32 prefix would promote every activation
        prefix = prefix.to(text_embeds.dtype)
        Lt = text_ids.shape[1]
        E = self.hidden_size
        dev = text_embeds.device

        if pad_embed is None:
            pad_embed = torch.zeros(E, dtype=text_embeds.dtype, device=dev)
        out_embeds = pad_embed.to(text_embeds.dtype)[None, None, :].expand(B, total_len, E)

        # compact each row's valid text to the right (a stable sort puts
        # the padding first), whatever side it was padded on
        n = text_mask.sum(dim=1)
        order = torch.argsort(text_mask, dim=1, stable=True)
        text_embeds_r = torch.take_along_dim(text_embeds, order[..., None], dim=1)

        tcol = torch.arange(total_len, device=dev)[None, :]
        src = tcol - (total_len - Lt)     # target column -> right-aligned text column
        text_valid_at = src >= (Lt - n)[:, None]
        src_c = src.clamp(0, Lt - 1).expand(B, total_len)
        emb_from_text = torch.take_along_dim(text_embeds_r, src_c[..., None], dim=1)
        is_prefix = tcol == (total_len - n - 1)[:, None]
        out_embeds = torch.where(text_valid_at[..., None], emb_from_text, out_embeds)
        out_embeds = torch.where(is_prefix[..., None], prefix, out_embeds)
        out_mask = (text_valid_at | is_prefix).long()
        out_labels = torch.full((B, total_len), -100, dtype=torch.long, device=dev)
        if labels is not None:
            labels_r = torch.take_along_dim(labels.long(), order, dim=1)
            out_labels = torch.where(text_valid_at, torch.take_along_dim(labels_r, src_c, dim=1),
                                     out_labels)
        return SoftPromptBatch(out_embeds, out_mask, out_labels)
