"""MultimodalTokenizer, eval path (counterpart of
``medtok_tpu/models/tokenizer_model.py``).

  frozen BERT -> text_mapped (768 -> graph out) per token
  GraphEncoder -> last hidden -> masked mean-pool
  h = cat(text [CLS], graph pool)
  SoftVQQuantizer -> embedding [B, 256], tokens [B, 4, k], weights [B, 4, k]

The encoders, ``text_mapped`` and the cross-attention hold their parameters
in ``cfg.compute_dtype`` (bf16 by default); the codebook and the specific
projections stay fp32, as the JAX package's dtype promotion has them.
"""

from __future__ import annotations

import torch
from torch import nn

from medtok_tpu_torch.config import ModelConfig
from medtok_tpu_torch.data.types import CodeBatch, TokenizedCodes
from medtok_tpu_torch.models.bert import BertEncoder
from medtok_tpu_torch.models.graph_encoder import GraphEncoder
from medtok_tpu_torch.models.layers import global_mean_pool
from medtok_tpu_torch.models.quantizer import SoftVQQuantizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: export row order of tokens_all / weights_all and the embedding parts
PATH_ORDER = ("text", "graph", "shared_text", "shared_graph")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}") from None


class MultimodalTokenizer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.text_model = BertEncoder(cfg.text, dtype=dt, device=device)
        self.graph_encoder = GraphEncoder(cfg.graph, dtype=dt, device=device)
        self.text_mapped = nn.Linear(cfg.text.hidden_size, cfg.graph.out_channels,
                                     dtype=dt, device=device)
        self.quantize = SoftVQQuantizer(cfg.quantizer, cfg.split, dtype=dt,
                                        device=device)

    def _tokenize(self, text_features, text_mask, batch: CodeBatch) -> TokenizedCodes:
        graph_nodes = self.graph_encoder(
            batch.node_ids, batch.edge_src, batch.edge_dst, batch.edge_weight
        )[-1]                                          # [B, Ln, D]
        node_mask = batch.node_mask.bool()
        graph_features = global_mean_pool(graph_nodes, node_mask)
        h = torch.cat([text_features[:, 0, :], graph_features], dim=-1)
        q = self.quantize(h, text_features, graph_nodes, text_mask.bool(), node_mask)
        return TokenizedCodes(
            embedding=torch.cat([q[p].z_q.float() for p in PATH_ORDER], dim=-1),
            tokens=torch.stack([q[p].indices for p in PATH_ORDER], dim=1).to(torch.int32),
            weights=torch.stack([q[p].weights for p in PATH_ORDER], dim=1),
        )

    def encode_text_packed(self, packed_ids, mask_or_segments, pos_ids):
        """BERT over packed [R, P] rows with within-segment positions ->
        flat [R*P, hidden] states. ``mask_or_segments``: [R, P] segment ids
        (0 = padding), which take kernel K2 when ``cfg.text.packed_flash`` is
        set, or an [R, P, P] bool pairwise mask for dense attention."""
        if mask_or_segments.dim() == 2:
            mask, segments = None, mask_or_segments.to(torch.int32)
        else:
            mask, segments = mask_or_segments.bool(), None
        hidden = self.text_model(packed_ids, mask, position_ids=pos_ids,
                                 segments=segments)
        return hidden.reshape(-1, hidden.shape[-1])

    def tokenize_from_hidden(self, flat_hidden, gather_idx, text_mask,
                             batch: CodeBatch) -> TokenizedCodes:
        """Quantizer tail on per-code states gathered from packed rows:
        gather_idx [B, Lmax] flat indices, text_mask [B, Lmax]; the batch's
        graph fields are used, its text fields are not."""
        text_features = self.text_mapped(flat_hidden[gather_idx])
        return self._tokenize(text_features, text_mask, batch)

    def forward(self, batch: CodeBatch) -> TokenizedCodes:
        """Unpacked eval tokenization (dense-attention BERT per code)."""
        hidden = self.text_model(batch.input_ids, batch.attention_mask)
        return self._tokenize(self.text_mapped(hidden), batch.attention_mask, batch)

    tokenize = forward
