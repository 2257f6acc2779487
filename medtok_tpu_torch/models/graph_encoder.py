"""Graph encoder over KG subgraphs (counterpart of
``medtok_tpu/models/graph_encoder.py``): a node-embedding table followed by
two GCNConv layers with a ReLU between; returns each layer's hidden states.
"""

from __future__ import annotations

import torch
from torch import nn

from medtok_tpu_torch.config import GraphEncoderConfig
from medtok_tpu_torch.models.layers import GCNConv, gcn_norm_adj

# At or above this padded node count, aggregation runs as a dense
# normalized-adjacency batched matmul instead of edge-list scatters.
DENSE_ADJ_MIN_NODES = 64


class GraphEncoder(nn.Module):
    def __init__(self, cfg: GraphEncoderConfig, *, dtype=None, device=None):
        super().__init__()
        if cfg.model_name != "GCN":
            raise NotImplementedError(
                f"graph model {cfg.model_name!r}: only GCN is ported")
        fk = {"dtype": dtype, "device": device}
        self.emb = nn.Embedding(cfg.num_nodes, cfg.in_channels, **fk)
        self.conv1 = GCNConv(cfg.in_channels, cfg.hidden_channels, **fk)
        self.conv2 = GCNConv(cfg.hidden_channels, cfg.out_channels, **fk)

    def forward(self, node_ids, edge_src, edge_dst, edge_weight) -> list[torch.Tensor]:
        """node_ids [B, Ln]; edges [E] within-graph indices chunked per graph
        (graph i owns slots [i*E/B, (i+1)*E/B))."""
        B, Ln = node_ids.shape
        x = self.emb(node_ids.long()).reshape(B * Ln, -1)
        E = edge_src.shape[0]
        if E % B:
            raise ValueError("edge array must be per-graph chunked")
        adj = None
        if Ln >= DENSE_ADJ_MIN_NODES:
            adj = gcn_norm_adj(edge_src, edge_dst, edge_weight, B, Ln, dtype=x.dtype)
        offset = torch.arange(E, device=x.device) // (E // B) * Ln
        src = edge_src.long() + offset
        dst = edge_dst.long() + offset
        h1 = self.conv1(x, src, dst, edge_weight, adj=adj)
        h2 = self.conv2(torch.relu(h1), src, dst, edge_weight, adj=adj)
        return [h1.reshape(B, Ln, -1), h2.reshape(B, Ln, -1)]
