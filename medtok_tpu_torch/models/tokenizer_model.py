"""MultimodalTokenizer (counterpart of
``medtok_tpu/models/tokenizer_model.py``).

  frozen BERT -> text_mapped (768 -> graph out) per token
  GraphEncoder -> last hidden -> masked mean-pool
  h = cat(text [CLS], graph pool)
  eval:  SoftVQQuantizer -> embedding [B, 256], tokens [B, 4, k], weights [B, 4, k]
  train: the same on h, plus h_aug = cat(text [CLS], pool of the GCN over
         the edge-dropped graph) -> the quantizer's loss dict

The encoders, ``text_mapped`` and the cross-attention compute in
``cfg.compute_dtype`` (bf16 by default) and hold their parameters in
``param_dtype``: the compute dtype for eval, fp32 for training (flax keeps
fp32 parameters and casts them where a module's ``dtype`` is set). The
frozen BERT keeps the compute dtype and takes no gradient. The codebook and
the specific projections stay fp32, as the JAX package's dtype promotion
has them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from medtok_tpu_torch.config import ModelConfig
from medtok_tpu_torch.data.types import CodeBatch, PackedTextBatch, TokenizedCodes
from medtok_tpu_torch.models.bert import BertEncoder
from medtok_tpu_torch.models.graph_encoder import GraphEncoder
from medtok_tpu_torch.models.layers import CastLinear, global_mean_pool
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
    def __init__(self, cfg: ModelConfig, *, param_dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        fk = {"dtype": dt, "param_dtype": param_dtype, "device": device}
        self.text_model = BertEncoder(cfg.text, dtype=dt, device=device)
        self.text_model.requires_grad_(False)
        self.graph_encoder = GraphEncoder(cfg.graph, **fk)
        self.text_mapped = CastLinear(cfg.text.hidden_size, cfg.graph.out_channels, **fk)
        self.quantize = SoftVQQuantizer(cfg.quantizer, cfg.split, **fk)

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

    def forward_train(self, batch: CodeBatch, *, packed: PackedTextBatch | None = None,
                      generator: torch.Generator | None = None) -> dict:
        """The training forward: the quantizer's result dict (losses,
        embeddings, usage) on the clean view and the augmented one, whose
        graph is the batch's edge-dropped copy and whose text [CLS] is the
        clean one. ``packed``: the batch's texts packed into shared rows
        (``data/packing.py::pack_code_batch``), which the frozen BERT runs
        over through kernel K2; without it the BERT runs over the batch's
        padded texts with dense attention. ``generator`` draws the
        cross-attention's dropout masks. The BERT runs without autograd and
        K2 never sees a tensor that requires a gradient. The ``train.*``
        ranges name the parts in a torch.profiler trace."""
        c = self.cfg
        if c.text_dropout_in_train:
            raise NotImplementedError(
                "text_dropout_in_train needs dropout in the frozen BERT, which the "
                "port lacks (ROADMAP Queue 1: BERT dropout for training)")
        with torch.no_grad(), record_function("train.bert"):
            if packed is not None:
                flat = self.encode_text_packed(packed.input_ids, packed.seg_ids,
                                               packed.pos_ids)
                text_hidden = flat[packed.gather_idx]
                text_mask = packed.text_mask.bool()
            else:
                text_hidden = self.text_model(batch.input_ids, batch.attention_mask)
                text_mask = batch.attention_mask.bool()
        with record_function("train.text_mapped"):
            text_features = self.text_mapped(text_hidden)          # [B, Lt, D]
            text_cls = text_features[:, 0, :]
        node_mask = batch.node_mask.bool()
        with record_function("train.gcn"):
            graph_nodes = self.graph_encoder(
                batch.node_ids, batch.edge_src, batch.edge_dst, batch.edge_weight)[-1]
            h = torch.cat([text_cls, global_mean_pool(graph_nodes, node_mask)], dim=-1)
        with record_function("train.gcn"):
            graph_aug = self.graph_encoder(
                batch.node_ids, batch.edge_src_aug, batch.edge_dst_aug,
                batch.edge_weight_aug)[-1]
            h_aug = torch.cat([text_cls, global_mean_pool(graph_aug, node_mask)], dim=-1)
        return self.quantize.forward_train(h, text_features, graph_nodes, text_mask,
                                           node_mask, h_aug, generator=generator)
