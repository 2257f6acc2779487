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

With ``use_kmeans`` the codebook is no parameter but EMA state: the
non-persistent buffers ``ema_codebook`` [C, D] (l2-unit rows), ``ema_cluster``
[C] and, with ``codebook_revival``, ``ema_embed_prob`` [C], outside the
state_dict as the flax ``usage`` collection is. Every sweep reads ``_cb()``.
``forward_train`` writes them after its six sweeps from the top-1 rows of
the shared text, shared graph, text-specific and graph-specific sweeps (the
norm-EMA update, and with revival the dead-code rewrite toward the closest
feature); the write assigns new tensors, so the autograd graph keeps the
codebook its sweeps read.

On a mesh (``dp``, the JAX module's ``dp_axis`` and ``tp_axis``): the
usage FIFO takes the dp blocks' indices gathered in order, the EMA write
sums the bin counts and feature sums over the dp axis, and revival picks
its anchors from the features gathered over it, so every rank holds the
same buffers. Each of these runs over the dp axis only: the tp ranks of a
block hold the same rows, and over the world they would count tp times.
With a tp axis above 1 every sweep, the eval ones too, is the
tensor-parallel one (``ops.vq.distance_topk_tp``): the specific sweeps by
their region's global rows.
"""

from __future__ import annotations

import torch
from torch import nn

from medtok_tpu_torch.config import QuantizerConfig
from medtok_tpu_torch.models.layers import CrossAttention, global_mean_pool
from medtok_tpu_torch.ops import vq as vq_ops
from medtok_tpu_torch.ops.ema import assignment_stats, ema_update, norm_ema_weight
from medtok_tpu_torch.utils.profiling import span


class SoftVQQuantizer(nn.Module):
    def __init__(self, cfg: QuantizerConfig, split: tuple[int, int], *,
                 dtype=None, param_dtype=None, device=None, dp=None):
        """``dtype`` is the cross-attention's compute dtype, ``param_dtype``
        its parameters' (default: ``dtype``); the codebook and the specific
        projections stay fp32. ``dp``: the ``parallel.mesh.DataParallel`` of a
        run on a (dp, tp) mesh, or None."""
        super().__init__()
        self.cfg = cfg
        self.split = split
        self.dp = dp
        C, D = cfg.codebook_size, cfg.codebook_embed_dim
        if cfg.use_kmeans:
            # a placeholder of unit rows: kmeans_init_codebook overwrites it
            placeholder = vq_ops.l2_normalize(torch.randn(
                (C, D), generator=torch.Generator().manual_seed(0)))
            self.register_buffer("ema_codebook", placeholder.to(device), persistent=False)
            self.register_buffer("ema_cluster", torch.zeros(
                C, dtype=torch.float32, device=device), persistent=False)
            if cfg.codebook_revival:
                # zero: every code may be revived on the first batch
                self.register_buffer("ema_embed_prob", torch.zeros(
                    C, dtype=torch.float32, device=device), persistent=False)
        else:
            self.codebook = nn.Parameter(torch.empty(
                (C, D), dtype=torch.float32, device=device))
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

    def _cb(self) -> torch.Tensor:
        """The codebook: the parameter, or the EMA buffer under use_kmeans."""
        return self.ema_codebook if self.cfg.use_kmeans else self.codebook

    def _quantize(self, z, region=None, *, train: bool = False):
        c = self.cfg
        return vq_ops.soft_topk_quantize(
            z, self._cb(), k=c.top_k, beta=c.commit_loss_beta, l2_norm=c.l2_norm,
            train=train, region=region, backend=c.topk_backend, mesh=self.dp,
        )

    def _track_usage(self, indices: torch.Tensor) -> torch.Tensor:
        """Push ``indices`` into the usage FIFO; the share of the codebook
        in it (0 when ``show_usage`` is off)."""
        c = self.cfg
        if not c.show_usage:
            return torch.zeros((), dtype=torch.float32, device=indices.device)
        if self.dp is not None:
            indices = self.dp.all_gather(indices, axis="dp")
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

    def shared_pooled(self, z_text, z_graph, text_mask, node_mask):
        """The shared path's pooled rows, l2-normalised in fp32, with no
        dropout and no quantization (the k-means init's data)."""
        t, g = self._shared_rows(z_text, z_graph, text_mask, node_mask)
        return vq_ops.l2_normalize(t.float()), vq_ops.l2_normalize(g.float())

    @torch.no_grad()
    def _ema_codebook_update(self, flat_n: torch.Tensor, top1: torch.Tensor) -> None:
        """The norm-EMA codebook write from l2-normalised features flat_n
        [M, D] and their top-1 full-codebook rows top1 [M]: per-row bin
        counts and feature sums (``index_put_``, deterministic on CUDA), the
        normalised mean of each row's features (an empty row keeps its
        codeword), ``norm_ema_update``, ``ema_update`` of the counts; with
        revival the EMA of each row's share of the assignments, and rows
        whose share decayed pulled toward the feature most similar to them
        (the first on ties) by exp(-share * C * 10 / (1 - decay) - 1e-3),
        then re-normalised."""
        c = self.cfg
        C, decay = c.codebook_size, c.codebook_ema_decay
        w = self.ema_codebook
        flat_n = flat_n.detach().float()
        bins, embed_sum = assignment_stats(flat_n, top1.long(), C)
        if self.dp is not None:
            self.dp.all_reduce_sum_([bins, embed_sum], axis="dp")
        new_w = norm_ema_weight(w, bins, embed_sum, decay)
        self.ema_cluster = ema_update(self.ema_cluster, bins, decay)
        if c.codebook_revival:
            avg_probs = bins / torch.clamp(bins.sum(), min=1.0)
            prob = ema_update(self.ema_embed_prob, avg_probs, decay)
            self.ema_embed_prob = prob
            feats = flat_n if self.dp is None else self.dp.all_gather(flat_n, axis="dp")
            anchor = feats[torch.argmax(feats @ new_w.T, dim=0)]          # [C, D]
            revive = torch.exp(-(prob * C * 10.0) / (1.0 - decay) - 1e-3)[:, None]
            new_w = vq_ops.l2_normalize(new_w * (1.0 - revive) + anchor * revive)
        self.ema_codebook = new_w

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
        with span("train.cross_attn"):
            z_flat_text, z_flat_graph = self._shared_rows(
                text_features, graph_node_features, text_mask, node_mask,
                generator=generator, deterministic=False)
        with span("train.vq"):
            return self._quantize_train(z, z_aug, z_flat_text, z_flat_graph)

    def _quantize_train(self, z, z_aug, z_flat_text, z_flat_graph) -> dict:
        """forward_train's six sweeps, their losses and the usage FIFO; the
        EMA codebook write under use_kmeans."""
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
            e_n = vq_ops.l2_normalize(self._cb().float())
            out["shared_affinity"] = -torch.cat(
                [vq_ops.squared_distance(z_text_n, e_n),
                 vq_ops.squared_distance(z_graph_n, e_n)], dim=0)
        if c.use_kmeans:
            # all three sites feed the write (the shared path alone starves
            # the specific regions); the aug sweeps would count samples twice
            g_off = c.codebook_size - c.codebook_size // 3
            self._ema_codebook_update(
                torch.cat([z_text_n, z_graph_n, text_loss[2], graph_loss[2]]),
                torch.cat([q_text.indices[:, 0], q_graph.indices[:, 0],
                           q_t.indices[:, 0], q_g.indices[:, 0] + g_off]))
        return out
