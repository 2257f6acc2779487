"""Graph encoder over KG subgraphs (counterpart of
``medtok_tpu/models/graph_encoder.py``): a node-embedding table followed by
two GCNConv layers (``model_name="GCN"``) or two GATConv layers ("GAT":
``gat_num_heads`` heads concatenated, then one head) with a ReLU between;
returns each layer's hidden states.
"""

from __future__ import annotations

import torch
from torch import nn

from medtok_tpu_torch.config import GraphEncoderConfig
from medtok_tpu_torch.models.layers import CastEmbedding, GATConv, GCNConv, gcn_norm_adj

# At or above this padded node count, GCN aggregation runs as a dense
# normalized-adjacency batched matmul instead of edge-list scatters.
DENSE_ADJ_MIN_NODES = 64


class GraphEncoder(nn.Module):
    def __init__(self, cfg: GraphEncoderConfig, *, dtype=None, param_dtype=None,
                 device=None):
        """Computes in ``dtype``; parameters in ``param_dtype`` (default:
        ``dtype``)."""
        super().__init__()
        fk = {"dtype": dtype, "param_dtype": param_dtype, "device": device}
        self.model_name = cfg.model_name
        self.emb = CastEmbedding(cfg.num_nodes, cfg.in_channels, **fk)
        if cfg.model_name == "GCN":
            self.conv1 = GCNConv(cfg.in_channels, cfg.hidden_channels, **fk)
            self.conv2 = GCNConv(cfg.hidden_channels, cfg.out_channels, **fk)
        elif cfg.model_name == "GAT":
            H = cfg.gat_num_heads
            self.conv1 = GATConv(cfg.in_channels, cfg.hidden_channels, H, **fk)
            # conv1's heads are concatenated: conv2 reads hidden * heads
            self.conv2 = GATConv(cfg.hidden_channels * H, cfg.out_channels, 1, **fk)
        else:
            raise ValueError("Invalid graph model name. Please choose from 'GCN' or 'GAT'.")

    def forward(self, node_ids, edge_src, edge_dst, edge_weight) -> list[torch.Tensor]:
        """node_ids [B, Ln]; edges [E] within-graph indices chunked per graph
        (graph i owns slots [i*E/B, (i+1)*E/B))."""
        B, Ln = node_ids.shape
        x = self.emb(node_ids.long()).reshape(B * Ln, -1)
        E = edge_src.shape[0]
        if E % B:
            raise ValueError("edge array must be per-graph chunked")
        offset = torch.arange(E, device=x.device) // (E // B) * Ln
        src = edge_src.long() + offset
        dst = edge_dst.long() + offset
        if self.model_name == "GAT":
            h1 = self.conv1(x, src, dst, edge_weight)
            h2 = self.conv2(torch.relu(h1), src, dst, edge_weight)
        else:
            adj = None
            if Ln >= DENSE_ADJ_MIN_NODES:
                adj = gcn_norm_adj(edge_src, edge_dst, edge_weight, B, Ln, dtype=x.dtype)
            h1 = self.conv1(x, src, dst, edge_weight, adj=adj)
            h2 = self.conv2(torch.relu(h1), src, dst, edge_weight, adj=adj)
        return [h1.reshape(B, Ln, -1), h2.reshape(B, Ln, -1)]
