"""SoftVQQuantizer (counterpart of ``medtok_tpu/models/quantizer.py``).

Three quantization paths per code share one codebook [n_e, e_dim]:
  1. shared: bidirectional cross-attention between the code's text tokens
     and graph nodes, [CLS] / masked-mean pooling, soft top-k against the
     full codebook (two sweeps: text and graph);
  2. text-specific: proj_text(z_text) against rows [0, n_e//3);
  3. graph-specific: proj_graph(z_graph) against rows [n_e - n_e//3, n_e).
Specific indices are region-local.

``forward`` is the eval path (four QuantizeOuts, no usage written).
``forward_train`` adds the augmented view's two specific sweeps (six K1
sweeps in all), the vq / commit losses of each path, and the usage FIFO:
the buffers ``codebook_used`` / ``usage_counts`` (the flax ``usage``
collection) take the shared path's indices, then text, graph, text-aug and
graph-aug, in that order. Its ``train.cross_attn`` and ``train.vq`` ranges
name its two parts in a torch.profiler trace.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from medtok_tpu_torch.config import QuantizerConfig
from medtok_tpu_torch.models.layers import CrossAttention, global_mean_pool
from medtok_tpu_torch.ops import vq as vq_ops


class SoftVQQuantizer(nn.Module):
    def __init__(self, cfg: QuantizerConfig, split: tuple[int, int], *,
                 dtype=None, param_dtype=None, device=None):
        """``dtype`` is the cross-attention's compute dtype, ``param_dtype``
        its parameters' (default: ``dtype``); the codebook and the specific
        projections stay fp32."""
        super().__init__()
        if cfg.use_kmeans:
            raise NotImplementedError("the EMA (--kmeans) codebook is not ported")
        self.cfg = cfg
        self.split = split
        D = cfg.codebook_embed_dim
        self.codebook = nn.Parameter(torch.empty(
            (cfg.codebook_size, D), dtype=torch.float32, device=device))
        self.cross_attn = CrossAttention(D, cfg.num_heads, cfg.cross_attn_layers,
                                         dropout=cfg.cross_attn_dropout, dtype=dtype,
                                         param_dtype=param_dtype, device=device)
        self.proj_text = nn.Linear(D, D, dtype=torch.float32, device=device)
        self.proj_graph = nn.Linear(D, D, dtype=torch.float32, device=device)
        if cfg.show_usage:
            # training state, not parameters: outside the state_dict, which
            # maps one to one onto the flax params tree
            self.register_buffer("codebook_used", torch.zeros(
                cfg.usage_buffer_size, dtype=torch.int32, device=device),
                persistent=False)
            self.register_buffer("usage_counts", vq_ops.usage_counts_init(
                cfg.codebook_size, cfg.usage_buffer_size, device=device),
                persistent=False)

    def _quantize(self, z, region=None, *, train: bool = False):
        c = self.cfg
        return vq_ops.soft_topk_quantize(
            z, self.codebook, k=c.top_k, beta=c.commit_loss_beta, l2_norm=c.l2_norm,
            train=train, region=region, backend=c.topk_backend,
        )

    def _track_usage(self, indices: torch.Tensor) -> torch.Tensor:
        """Push ``indices`` into the usage FIFO; the share of the codebook
        in it (0 when ``show_usage`` is off)."""
        c = self.cfg
        if not c.show_usage:
            return torch.zeros((), dtype=torch.float32, device=indices.device)
        buf, counts, usage = vq_ops.usage_update(
            self.codebook_used, self.usage_counts, indices, c.codebook_size)
        self.codebook_used.copy_(buf)
        self.usage_counts.copy_(counts)
        return usage

    def _shared_rows(self, z_text, z_graph, text_mask, node_mask, *,
                     generator=None, deterministic: bool = True):
        """The shared path's pooled rows: [CLS] of the text after
        cross-attention, masked mean of the graph nodes after it. Dropout
        only where ``deterministic`` is False."""
        t_attn, g_attn = self.cross_attn(z_text, z_graph, text_mask, node_mask,
                                         generator=generator, deterministic=deterministic)
        return t_attn[:, 0, :], global_mean_pool(g_attn, node_mask)

    def get_shared_info(self, z_text, z_graph, text_mask, node_mask):
        """z_text [B, Lt, D], z_graph [B, Ln, D], masks True = valid.
        Returns (shared text q, shared graph q)."""
        z_flat_text, z_flat_graph = self._shared_rows(z_text, z_graph, text_mask, node_mask)
        return self._quantize(z_flat_text), self._quantize(z_flat_graph)

    def specific_embedding(self, z, types: str, *, train: bool = False):
        """Modality-specific quantization against the codebook region of
        ``types`` ('text' or 'graph'); the projection runs in fp32. Returns
        (QuantizeOut, the projection)."""
        proj = self.proj_text if types == "text" else self.proj_graph
        z_p = proj(z.float())
        return self._quantize(z_p, region=types, train=train), z_p

    def forward(self, z, text_features, graph_node_features, text_mask, node_mask):
        """z [B, split0 + split1] = cat(text_cls, graph_pool). Returns the
        four paths' QuantizeOuts keyed text, graph, shared_text, shared_graph
        (the export row order)."""
        s0 = self.split[0]
        q_st, q_sg = self.get_shared_info(text_features, graph_node_features,
                                          text_mask, node_mask)
        return {
            "text": self.specific_embedding(z[:, :s0], "text")[0],
            "graph": self.specific_embedding(z[:, s0:], "graph")[0],
            "shared_text": q_st,
            "shared_graph": q_sg,
        }

    def forward_train(self, z, text_features, graph_node_features, text_mask,
                      node_mask, z_aug, *, generator=None) -> dict:
        """The JAX quantizer's training result dict, keys and loss tuples
        alike. z and z_aug [B, split0 + split1] are the clean and the
        augmented cat(text_cls, graph_pool). The cross-attention's dropout
        applies, its masks drawn from ``generator``. Writes the usage FIFO."""
        with record_function("train.cross_attn"):
            z_flat_text, z_flat_graph = self._shared_rows(
                text_features, graph_node_features, text_mask, node_mask,
                generator=generator, deterministic=False)
        with record_function("train.vq"):
            return self._quantize_train(z, z_aug, z_flat_text, z_flat_graph)

    def _quantize_train(self, z, z_aug, z_flat_text, z_flat_graph) -> dict:
        """forward_train's six sweeps, their losses and the usage FIFO."""
        c = self.cfg
        s0 = self.split[0]
        q_text = self._quantize(z_flat_text, train=True)
        q_graph = self._quantize(z_flat_graph, train=True)
        shared_usage = self._track_usage(torch.cat([q_text.indices, q_graph.indices], -1))
        z_text_n = vq_ops.l2_normalize(z_flat_text.float())
        z_graph_n = vq_ops.l2_normalize(z_flat_graph.float())
        shared_loss = (q_text.vq_loss + q_graph.vq_loss,
                       q_text.commit_loss + q_graph.commit_loss,
                       z_text_n, z_graph_n, q_text.z_q, q_graph.z_q)
        spec = {}   # each path's (QuantizeOut, projection, usage), FIFO in this order
        for name, part, types in (("text", z[:, :s0], "text"),
                                  ("graph", z[:, s0:], "graph"),
                                  ("text_aug", z_aug[:, :s0], "text"),
                                  ("graph_aug", z_aug[:, s0:], "graph")):
            q, z_p = self.specific_embedding(part, types, train=True)
            spec[name] = (q, z_p, self._track_usage(q.indices))
        q_t, zp_t, text_usage = spec["text"]
        q_g, zp_g, graph_usage = spec["graph"]
        text_loss = (q_t.vq_loss, q_t.commit_loss, vq_ops.l2_normalize(zp_t), q_t.z_q)
        graph_loss = (q_g.vq_loss, q_g.commit_loss, vq_ops.l2_normalize(zp_g), q_g.z_q)
        out = {
            "graph_feature": z[:, s0:],
            "text_feature": z[:, :s0],
            "shared_text_embedding": q_text.z_q,
            "shared_graph_embedding": q_graph.z_q,
            "shared_embed_loss": shared_loss,
            "shared_codebook_usage": shared_usage,
            "specific_embedding_text": q_t.z_q,
            "text_specific_loss": text_loss,
            "text_specific_usage": text_usage,
            "specific_embedding_graph": q_g.z_q,
            "graph_specific_loss": graph_loss,
            "graph_specific_usage": graph_usage,
            "specific_embedding_text_aug": spec["text_aug"][0].z_q,
            "specific_embedding_graph_aug": spec["graph_aug"][0].z_q,
            "text_tokens": q_t.indices,
            "text_tokens_weights": q_t.weights,
            "graph_tokens": q_g.indices,
            "graph_tokens_weights": q_g.weights,
            "shared_text_tokens": q_text.indices,
            "shared_text_tokens_weights": q_text.weights,
            "shared_graph_tokens": q_graph.indices,
            "shared_graph_tokens_weights": q_graph.weights,
        }
        if c.entropy_loss_ratio > 0:
            # the entropy term's input: minus the squared distances of the
            # normalized pooled rows to the whole normalized codebook
            e_n = vq_ops.l2_normalize(self.codebook.float())
            out["shared_affinity"] = -torch.cat(
                [vq_ops.squared_distance(z_text_n, e_n),
                 vq_ops.squared_distance(z_graph_n, e_n)], dim=0)
        return out
