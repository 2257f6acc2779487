"""SoftVQQuantizer, eval path (counterpart of
``medtok_tpu/models/quantizer.py``).

Three quantization paths per code share one codebook [n_e, e_dim]:
  1. shared: bidirectional cross-attention between the code's text tokens
     and graph nodes, [CLS] / masked-mean pooling, soft top-k against the
     full codebook (two sweeps: text and graph);
  2. text-specific: proj_text(z_text) against rows [0, n_e//3);
  3. graph-specific: proj_graph(z_graph) against rows [n_e - n_e//3, n_e).
Specific indices are region-local. Eval writes no usage FIFO.
"""

from __future__ import annotations

import torch
from torch import nn

from medtok_tpu_torch.config import QuantizerConfig
from medtok_tpu_torch.models.layers import CrossAttention, global_mean_pool
from medtok_tpu_torch.ops import vq as vq_ops


class SoftVQQuantizer(nn.Module):
    def __init__(self, cfg: QuantizerConfig, split: tuple[int, int], *,
                 dtype=None, device=None):
        """``dtype`` is the cross-attention's compute dtype; the codebook
        and the specific projections stay fp32."""
        super().__init__()
        if cfg.use_kmeans:
            raise NotImplementedError("the EMA (--kmeans) codebook is not ported")
        self.cfg = cfg
        self.split = split
        D = cfg.codebook_embed_dim
        self.codebook = nn.Parameter(torch.empty(
            (cfg.codebook_size, D), dtype=torch.float32, device=device))
        self.cross_attn = CrossAttention(D, cfg.num_heads, cfg.cross_attn_layers,
                                         dtype=dtype, device=device)
        self.proj_text = nn.Linear(D, D, dtype=torch.float32, device=device)
        self.proj_graph = nn.Linear(D, D, dtype=torch.float32, device=device)

    def _quantize(self, z, region=None):
        c = self.cfg
        return vq_ops.soft_topk_quantize(
            z, self.codebook, k=c.top_k, l2_norm=c.l2_norm, region=region,
            backend=c.topk_backend,
        )

    def get_shared_info(self, z_text, z_graph, text_mask, node_mask):
        """z_text [B, Lt, D], z_graph [B, Ln, D], masks True = valid.
        Returns (shared text q, shared graph q)."""
        t_attn, g_attn = self.cross_attn(z_text, z_graph, text_mask, node_mask)
        q_text = self._quantize(t_attn[:, 0, :])
        q_graph = self._quantize(global_mean_pool(g_attn, node_mask))
        return q_text, q_graph

    def specific_embedding(self, z, types: str):
        """Modality-specific quantization against the codebook region of
        ``types`` ('text' or 'graph'); the projection runs in fp32."""
        proj = self.proj_text if types == "text" else self.proj_graph
        return self._quantize(proj(z.float()), region=types)

    def forward(self, z, text_features, graph_node_features, text_mask, node_mask):
        """z [B, split0 + split1] = cat(text_cls, graph_pool). Returns the
        four paths' QuantizeOuts keyed text, graph, shared_text, shared_graph
        (the export row order)."""
        s0 = self.split[0]
        q_st, q_sg = self.get_shared_info(text_features, graph_node_features,
                                          text_mask, node_mask)
        return {
            "text": self.specific_embedding(z[:, :s0], "text"),
            "graph": self.specific_embedding(z[:, s0:], "graph"),
            "shared_text": q_st,
            "shared_graph": q_sg,
        }
