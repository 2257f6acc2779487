"""A plain PyTorch MedTok: the benchmark's reference for the export and the
training step (MedTok, arXiv:2502.04397; mims-harvard/MedTok
``MedTok/tokenizer.py``), written from the published model and the port's
documented semantics, importing nothing of the port.

One code is a description and a knowledge-graph subgraph:

  frozen BERT (post-LN, exact erf gelu) -> text_mapped per token
  two GCN layers (symmetric-normalized adjacency with a self-loop on every
  node) or two GAT layers (4 concatenated heads, then one) -> nodes
  h = cat(text [CLS], mean of the nodes)
  bidirectional cross-attention (2 shared layers, 4 heads): text attends to
  the nodes, the nodes to the text; [CLS] and the node mean are the shared
  rows
  soft top-5 against the l2-normalized codebook: shared rows against all
  21,000 rows, proj_text(text [CLS]) against rows [0, n/3),
  proj_graph(node mean) against rows [n - n/3, n); weights softmax(-d)

Everything runs in float32 with TF32 off, on padded batches the reference
builds itself from the raw corpus: its own WordPiece, its own induced
subgraphs in the knowledge graph's edge order, its own edge dropout (the
xoshiro256** stream the project's host packer draws, copied), its own bucket
choice. ``Precision("fp8")`` rounds every matrix product's operands to
float8 e4m3 (per-tensor scale) and the codebook distances' operands to TF32:
the control that a lower-precision program would give.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
PATHS = ("text", "graph", "shared_text", "shared_graph")   # export row order
#: the training sweeps in the order the usage FIFO takes them; a group of two
#: is pushed as one [B, 2k] block, each code's two rows side by side
FIFO_ORDER = (("shared_text", "shared_graph"), ("text",), ("graph",), ("text_aug",),
              ("graph_aug",))
ADAM_EPS = 1e-8
INFO_NCE_TEMPERATURE = 0.07


# ------------------------------------------------------------ precision --

class Precision:
    """Where the reference rounds: nowhere ("fp32"), or ("fp8") every matrix
    product's operands to float8 e4m3 with a per-tensor scale and the
    codebook distances' operands to TF32 (10 mantissa bits). Rounding is
    straight-through, so gradients flow as through the identity."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def gemm(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()

    def dist(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        bits = x.detach().contiguous().view(torch.int32)
        q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (q - x).detach()


def linear(x, w, b, prec: Precision):
    y = prec.gemm(x) @ prec.gemm(w).T
    return y if b is None else y + b


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def l2_normalize(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def dropout(x, rate: float, gen: torch.Generator | None):
    """Inverted dropout with the mask drawn as uniform >= rate, in the shape
    of ``x``, from ``gen``."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


# --------------------------------------------------------------- inputs --

def wordpiece(text: str, vocab: dict[str, int], max_length: int) -> list[int]:
    """[CLS] + greedy longest-match WordPiece of the whitespace-split,
    lower-cased words ('##' continuations, [UNK] for a word that does not
    split) + [SEP], truncated to ``max_length`` with [SEP] kept."""
    ids = [vocab["[CLS]"]]
    for word in text.lower().split():
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in vocab:
                    cur = vocab[sub]
                    break
                end -= 1
            if cur is None:
                pieces = [vocab["[UNK]"]]
                break
            pieces.append(cur)
            start = end
        ids.extend(pieces)
    return ids[:max_length - 1] + [vocab["[SEP]"]]


class Graph:
    """The knowledge graph as adjacency lists: a node's out-edges in the
    order they appear in the edge list."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, num_nodes: int):
        order = np.argsort(src, kind="stable")
        self.nbr = np.asarray(dst, np.int64)[order]
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=num_nodes), out=self.indptr[1:])

    def induced(self, nodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Edges with both ends in the sorted ``nodes``, as (src, dst)
        positions in it, source nodes in list order and each node's
        out-edges in edge-list order."""
        lo, hi = self.indptr[nodes], self.indptr[nodes + 1]
        counts = hi - lo
        total = int(counts.sum())
        src = np.repeat(np.arange(len(nodes)), counts)
        first = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        nb = self.nbr[first + np.arange(total)]
        pos = np.clip(np.searchsorted(nodes, nb), 0, max(len(nodes) - 1, 0))
        hit = nodes[pos] == nb if len(nodes) else np.zeros(0, bool)
        return src[hit], pos[hit]


_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _u(x: int) -> np.uint64:
    return np.uint64(x & _M64)


def dropout_keeps(seed: int, num_edges: list[int], p: float) -> list[np.ndarray]:
    """Edge dropout of a batch: graph b's edges in order, each kept where a
    uniform from xoshiro256** (seeded by splitmix64 from seed * golden + b)
    exceeds ``p``."""
    B = len(num_edges)
    x = np.array([(seed * _GOLDEN + b) & _M64 for b in range(B)], np.uint64)
    s = []
    for _ in range(4):
        x = x + _u(_GOLDEN)
        z = x.copy()
        z = (z ^ (z >> _u(30))) * _u(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _u(27))) * _u(0x94D049BB133111EB)
        s.append(z ^ (z >> _u(31)))

    def rotl(v, k):
        return (v << _u(k)) | (v >> _u(64 - k))

    most = max(num_edges, default=0)
    draws = np.zeros((B, most))
    for e in range(most):
        result = rotl(s[1] * _u(5), 7) * _u(9)
        t = s[1] << _u(17)
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = rotl(s[3], 45)
        draws[:, e] = (result >> _u(11)).astype(np.float64) * 2.0 ** -53
    return [draws[b, :n] > p for b, n in enumerate(num_edges)]


def bucket(buckets, need: int) -> int:
    return next((b for b in buckets if need <= b), buckets[-1])


@dataclass
class Batch:
    """A padded batch the reference built: texts [B, Lt], nodes [B, Ln],
    and per-graph edge lists in flat node numbering b * Ln + i."""

    input_ids: torch.Tensor      # [B, Lt] int64
    text_mask: torch.Tensor      # [B, Lt] bool
    node_ids: torch.Tensor       # [B, Ln] int64
    node_mask: torch.Tensor      # [B, Ln] bool
    edges: torch.Tensor          # [2, E] int64 (src, dst) flat
    edges_aug: torch.Tensor      # [2, E'] int64


class Inputs:
    """What the reference derives from the raw corpus: token ids, subgraphs,
    buckets, the augmented view's edges."""

    def __init__(self, corpus, data_cfg: dict, device):
        self.corpus = corpus
        self.cfg = data_cfg
        self.device = device
        self.graph = Graph(corpus.kg_src, corpus.kg_dst, corpus.num_nodes)
        self._ids: dict[int, list[int]] = {}

    def ids(self, code: int) -> list[int]:
        if code not in self._ids:
            self._ids[code] = wordpiece(self.corpus.descs[code], self.corpus.vocab,
                                        self.cfg["max_text_length"])
        return self._ids[code]

    def subgraph(self, code: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nodes, src, dst) of a code, nodes cut to the largest node bucket
        and edges to the largest edge bucket, as the program's batches hold
        them."""
        nodes = np.asarray(self.corpus.node_lists[code], np.int64)[:max(self.cfg["node_buckets"])]
        src, dst = self.graph.induced(nodes)
        cap = max(self.cfg["edge_buckets"])
        return nodes, src[:cap], dst[:cap]

    def sizes(self, codes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """True (tokens, nodes, edges) of each code: no padding."""
        t, n, e = [], [], []
        for c in codes:
            nodes, src, _ = self.subgraph(int(c))
            t.append(len(self.ids(int(c))))
            n.append(len(nodes))
            e.append(len(src))
        return np.array(t), np.array(n), np.array(e)

    def batch(self, codes, *, aug_seed: int | None = None) -> Batch:
        """The padded batch of ``codes`` at the text bucket of the longest
        text and the node bucket of the largest graph; with ``aug_seed`` the
        augmented view drops edges at ``edge_dropout_p``."""
        c = self.cfg
        codes = [int(x) for x in codes]
        ids = [self.ids(x) for x in codes]
        graphs = [self.subgraph(x) for x in codes]
        B = len(codes)
        Lt = bucket(c["text_buckets"], max(len(t) for t in ids))
        Ln = bucket(c["node_buckets"], max(len(g[0]) for g in graphs))
        input_ids = np.zeros((B, Lt), np.int64)
        node_ids = np.zeros((B, Ln), np.int64)
        text_mask = np.zeros((B, Lt), bool)
        node_mask = np.zeros((B, Ln), bool)
        for b, (t, (nodes, _, _)) in enumerate(zip(ids, graphs)):
            input_ids[b, :len(t)] = t
            text_mask[b, :len(t)] = True
            node_ids[b, :len(nodes)] = nodes
            node_mask[b, :len(nodes)] = True
        keeps = (dropout_keeps(aug_seed, [len(g[1]) for g in graphs], c["edge_dropout_p"])
                 if aug_seed is not None else [np.ones(len(g[1]), bool) for g in graphs])

        def flat(select):
            src = np.concatenate([g[1][k] + b * Ln for b, (g, k) in
                                  enumerate(zip(graphs, select))] + [np.zeros(0, np.int64)])
            dst = np.concatenate([g[2][k] + b * Ln for b, (g, k) in
                                  enumerate(zip(graphs, select))] + [np.zeros(0, np.int64)])
            return torch.from_numpy(np.stack([src, dst]).astype(np.int64)).to(self.device)

        dev = self.device
        return Batch(torch.from_numpy(input_ids).to(dev), torch.from_numpy(text_mask).to(dev),
                     torch.from_numpy(node_ids).to(dev), torch.from_numpy(node_mask).to(dev),
                     flat([np.ones(len(g[1]), bool) for g in graphs]), flat(keeps))


# -------------------------------------------------------------- weights --

def param_spec(model_cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, family) of every parameter, named as the port's
    ``state_dict`` names them. Families: "fan_in" N(0, 1/fan_in) (dense
    kernels [out, in] and embedding tables [rows, dim], by the last axis),
    "unit" N(0, 1) (the codebook), "glorot" N(0, 2/(fan_in + fan_out)) (the
    GAT attention vectors), "zero" (biases), "one" (LayerNorm scales)."""
    t, g, q = model_cfg["text"], model_cfg["graph"], model_cfg["quantizer"]
    E, I = t["hidden_size"], t["intermediate_size"]
    spec = [("text_model.word_embeddings.weight", (t["vocab_size"], E), "fan_in"),
            ("text_model.position_embeddings.weight", (t["max_position_embeddings"], E), "fan_in"),
            ("text_model.token_type_embeddings.weight", (t["type_vocab_size"], E), "fan_in")]
    spec += _ln("text_model.embeddings_ln", E)
    for i in range(t["num_layers"]):
        p = f"text_model.layer_{i}."
        for name in ("attention.query", "attention.key", "attention.value", "attention_output"):
            spec += _dense(p + name, E, E)
        spec += _ln(p + "attention_ln", E)
        spec += _dense(p + "intermediate", E, I) + _dense(p + "output", I, E)
        spec += _ln(p + "output_ln", E)
    cin, hid, out = g["in_channels"], g["hidden_channels"], g["out_channels"]
    spec.append(("graph_encoder.emb.weight", (g["num_nodes"], cin), "fan_in"))
    if g["model_name"] == "GCN":
        for name, a, b in (("conv1", cin, hid), ("conv2", hid, out)):
            spec += [(f"graph_encoder.{name}.bias", (b,), "zero"),
                     (f"graph_encoder.{name}.lin.weight", (b, a), "fan_in")]
    else:
        H = g["gat_num_heads"]
        for name, a, heads, c in (("conv1", cin, H, hid), ("conv2", hid * H, 1, out)):
            spec += [(f"graph_encoder.{name}.att_src", (heads, c), "glorot"),
                     (f"graph_encoder.{name}.att_dst", (heads, c), "glorot"),
                     (f"graph_encoder.{name}.bias", (heads * c,), "zero"),
                     (f"graph_encoder.{name}.lin.weight", (heads * c, a), "fan_in")]
    D = q["codebook_embed_dim"]
    spec += _dense("text_mapped", E, out)
    spec.append(("quantize.codebook", (q["codebook_size"], D), "unit"))
    for i in range(q["cross_attn_layers"]):
        p = f"quantize.cross_attn.layer_{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec += _dense(p + "multihead_attn." + name, D, D)
        spec += _ln(p + "layer_norm", D)
    spec += _dense("quantize.proj_text", D, D) + _dense("quantize.proj_graph", D, D)
    return spec


def _dense(name, fan_in, fan_out):
    return [(name + ".weight", (fan_out, fan_in), "fan_in"), (name + ".bias", (fan_out,), "zero")]


def _ln(name, dim):
    return [(name + ".weight", (dim,), "one"), (name + ".bias", (dim,), "zero")]


def is_trainable(name: str) -> bool:
    """Everything but the frozen text encoder."""
    return not name.startswith("text_model.")


# ---------------------------------------------------------------- model --

class MedTok:
    """The forward passes on float32 copies of the given weights (a dict
    named as ``param_spec``); ``trainable`` leaves may require gradients."""

    def __init__(self, model_cfg: dict, weights: dict, prec: Precision | None = None):
        self.cfg = model_cfg
        self.w = weights
        self.prec = prec or Precision("fp32")

    # text -------------------------------------------------------------------
    def bert(self, ids: torch.Tensor, mask: torch.Tensor, rows: int = 256) -> torch.Tensor:
        """Last hidden states [B, Lt, E] of the frozen BERT, ``rows`` codes
        at a time."""
        return torch.cat([self._bert(ids[i:i + rows], mask[i:i + rows])
                          for i in range(0, ids.shape[0], rows)])

    def _bert(self, ids, mask):
        t, w, pr = self.cfg["text"], self.w, self.prec
        p = "text_model."
        B, L = ids.shape
        H, E = t["num_heads"], t["hidden_size"]
        Dh, eps = E // H, t["layer_norm_eps"]
        x = (w[p + "word_embeddings.weight"][ids]
             + w[p + "position_embeddings.weight"][torch.arange(L, device=ids.device)][None]
             + w[p + "token_type_embeddings.weight"][0])
        x = layer_norm(x, w[p + "embeddings_ln.weight"], w[p + "embeddings_ln.bias"], eps)
        for i in range(t["num_layers"]):
            q = f"{p}layer_{i}."

            def heads(name):
                y = linear(x, w[q + name + ".weight"], w[q + name + ".bias"], pr)
                return y.view(B, L, H, Dh).transpose(1, 2)

            qh, kh, vh = heads("attention.query"), heads("attention.key"), heads("attention.value")
            logits = pr.gemm(qh) @ pr.gemm(kh).transpose(-1, -2) / math.sqrt(Dh)
            attn = torch.softmax(torch.where(mask[:, None, None, :], logits, NEG_INF), -1)
            a = (pr.gemm(attn) @ pr.gemm(vh)).transpose(1, 2).reshape(B, L, E)
            a = linear(a, w[q + "attention_output.weight"], w[q + "attention_output.bias"], pr)
            x = layer_norm(x + a, w[q + "attention_ln.weight"], w[q + "attention_ln.bias"], eps)
            h = F.gelu(linear(x, w[q + "intermediate.weight"], w[q + "intermediate.bias"], pr))
            h = linear(h, w[q + "output.weight"], w[q + "output.bias"], pr)
            x = layer_norm(x + h, w[q + "output_ln.weight"], w[q + "output_ln.bias"], eps)
        return x

    # graph ------------------------------------------------------------------
    def graph(self, node_ids: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        """Last layer's node states [B, Ln, out] over the edges [2, E] (flat
        node numbering)."""
        g, w = self.cfg["graph"], self.w
        B, Ln = node_ids.shape
        x = w["graph_encoder.emb.weight"][node_ids].reshape(B * Ln, -1)
        if g["model_name"] == "GCN":
            adj = self.gcn_adjacency(edges, B, Ln)
            h = self._gcn(x, adj, "conv1")
            h = self._gcn(torch.relu(h), adj, "conv2")
        else:
            loops = torch.arange(B * Ln, device=x.device)
            src = torch.cat([edges[0], loops])
            dst = torch.cat([edges[1], loops])
            h = self._gat(x, src, dst, "conv1", g["gat_num_heads"])
            h = self._gat(torch.relu(h), src, dst, "conv2", 1)
        return h.view(B, Ln, -1)

    @staticmethod
    def gcn_adjacency(edges, B: int, Ln: int) -> torch.Tensor:
        """Dense [B, Ln, Ln] D^-1/2 C D^-1/2 + D^-1, with C[b, i, j] the
        number of edges j -> i and D = 1 + in-degree: every node's self-loop
        added once."""
        count = torch.zeros(B * Ln * Ln, device=edges.device)
        b, i, j = edges[1] // Ln, edges[1] % Ln, edges[0] % Ln
        count.index_put_((b * Ln * Ln + i * Ln + j,), torch.ones_like(i, dtype=torch.float32),
                         accumulate=True)
        count = count.view(B, Ln, Ln)
        dinv = torch.rsqrt(1.0 + count.sum(dim=2))
        adj = count * dinv[:, :, None] * dinv[:, None, :]
        return adj + torch.diag_embed(dinv * dinv)

    def _gcn(self, x, adj, name):
        w, pr = self.w, self.prec
        B, Ln, _ = adj.shape
        xw = linear(x, w[f"graph_encoder.{name}.lin.weight"], None, pr).view(B, Ln, -1)
        out = pr.gemm(adj) @ pr.gemm(xw)
        return out.reshape(B * Ln, -1) + w[f"graph_encoder.{name}.bias"]

    def _gat(self, x, src, dst, name, H):
        """Per-head additive attention over each node's incoming edges (a
        segment softmax by destination), messages summed by destination,
        heads concatenated, then the bias."""
        w, pr = self.w, self.prec
        n = x.shape[0]
        xw = linear(x, w[f"graph_encoder.{name}.lin.weight"], None, pr).view(n, H, -1)
        a_src = (xw * w[f"graph_encoder.{name}.att_src"]).sum(-1)
        a_dst = (xw * w[f"graph_encoder.{name}.att_dst"]).sum(-1)
        e = F.leaky_relu(a_src[src] + a_dst[dst], 0.2)
        e_max = torch.full((n, H), NEG_INF, device=x.device).scatter_reduce(
            0, dst[:, None].expand(-1, H), e, "amax", include_self=True)
        ex = torch.exp(e - e_max[dst])
        denom = torch.zeros((n, H), device=x.device).index_add(0, dst, ex)
        alpha = ex / denom[dst]
        msg = pr.gemm(alpha)[..., None] * pr.gemm(xw)[src]
        out = torch.zeros_like(xw).index_add(0, dst, msg)
        return out.reshape(n, -1) + w[f"graph_encoder.{name}.bias"]

    # cross-attention -------------------------------------------------------
    def cross_attention(self, v1, v2, m1, m2, gen=None):
        """v1 attends to the fixed v2 through every shared layer, then v2 to
        the fixed v1. With ``gen`` (training) dropout on the attention
        probabilities and on each layer's attention output, masks drawn in
        that order."""
        q = self.cfg["quantizer"]
        layers = range(q["cross_attn_layers"])
        a = v1
        for i in layers:
            a = self._cross_layer(i, a, v2, m2, gen)
        b = v2
        for i in layers:
            b = self._cross_layer(i, b, v1, m1, gen)
        return a, b

    def _cross_layer(self, i, query, key, key_mask, gen):
        qc, w, pr = self.cfg["quantizer"], self.w, self.prec
        p = f"quantize.cross_attn.layer_{i}."
        H, rate = qc["num_heads"], qc["cross_attn_dropout"]
        B, Lq, E = query.shape
        Lk, Dh = key.shape[1], E // H

        def proj(x, name, L):
            y = linear(x, w[p + f"multihead_attn.{name}.weight"],
                       w[p + f"multihead_attn.{name}.bias"], pr)
            return y.view(B, L, H, Dh).transpose(1, 2)

        qh, kh, vh = proj(query, "q_proj", Lq), proj(key, "k_proj", Lk), proj(key, "v_proj", Lk)
        logits = pr.gemm(qh) @ pr.gemm(kh).transpose(-1, -2) / math.sqrt(Dh)
        attn = torch.softmax(torch.where(key_mask[:, None, None, :], logits, NEG_INF), -1)
        attn = dropout(attn, rate, gen)
        out = (pr.gemm(attn) @ pr.gemm(vh)).transpose(1, 2).reshape(B, Lq, E)
        out = linear(out, w[p + "multihead_attn.out_proj.weight"],
                     w[p + "multihead_attn.out_proj.bias"], pr)
        out = dropout(out, rate, gen)
        return layer_norm(query + out, w[p + "layer_norm.weight"], w[p + "layer_norm.bias"], 1e-5)

    # quantizer ---------------------------------------------------------------
    def regions(self) -> dict[str, tuple[int, int]]:
        n = self.cfg["quantizer"]["codebook_size"]
        third = n // 3
        return {"text": (0, third), "graph": (n - third, n),
                "shared_text": (0, n), "shared_graph": (0, n)}

    def codebook_n(self) -> torch.Tensor:
        return l2_normalize(self.w["quantize.codebook"])

    def distances(self, z_n: torch.Tensor, e_n: torch.Tensor) -> torch.Tensor:
        """Squared L2 distances [B, N] of unit rows to unit codewords."""
        pr = self.prec
        return ((z_n * z_n).sum(-1, keepdim=True) + (e_n * e_n).sum(-1)[None, :]
                - 2.0 * (pr.dist(z_n) @ pr.dist(e_n).T))

    def quantize(self, z: torch.Tensor, region: str, *, train: bool = False) -> dict:
        """Soft top-k of z against the region's normalized rows: indices
        (region-local, lowest index first on ties), weights, the weighted
        codeword sum, and in training the vq and commit losses and the
        straight-through output."""
        qc = self.cfg["quantizer"]
        lo, hi = self.regions()[region]
        e_r = self.codebook_n()[lo:hi]
        z_n = l2_normalize(z)
        with torch.no_grad():
            d = self.distances(z_n, e_r)
            idx = torch.sort(d, dim=1, stable=True).indices[:, :qc["top_k"]]
        g = e_r[idx]
        values = ((z_n * z_n).sum(-1, keepdim=True) + (g * g).sum(-1)
                  - 2.0 * torch.einsum("bd,bkd->bk", z_n, g))
        weights = torch.softmax(-values, dim=-1)
        z_q_raw = (weights[..., None] * g).sum(dim=1)
        out = {"indices": idx, "weights": weights, "z_q_raw": z_q_raw, "z_n": z_n}
        if train:
            out["vq_loss"] = ((z.detach() - z_q_raw) ** 2).mean()
            out["commit_loss"] = qc["commit_loss_beta"] * ((z - z_q_raw.detach()) ** 2).mean()
            out["z_q"] = z + (z_q_raw - z).detach()
        return out

    # whole model -------------------------------------------------------------
    def encode(self, batch: Batch, *, edges=None, gen=None):
        """(text features [B, Lt, D], graph nodes [B, Ln, D], h [B, 2D])."""
        w, pr = self.w, self.prec
        with torch.no_grad():
            hidden = self.bert(batch.input_ids, batch.text_mask)
        feats = linear(hidden, w["text_mapped.weight"], w["text_mapped.bias"], pr)
        nodes = self.graph(batch.node_ids, batch.edges if edges is None else edges)
        return feats, nodes, self.pooled(feats, nodes, batch.node_mask)

    @staticmethod
    def pooled(feats, nodes, node_mask):
        m = node_mask.float()[..., None]
        pool = (nodes * m).sum(1) / m.sum(1).clamp(min=1.0)
        return torch.cat([feats[:, 0], pool], dim=-1)

    def path_inputs(self, feats, nodes, h, batch, gen=None) -> dict[str, torch.Tensor]:
        """The four paths' rows before quantization."""
        w, pr = self.w, self.prec
        D = self.cfg["quantizer"]["codebook_embed_dim"]
        t_attn, g_attn = self.cross_attention(feats, nodes, batch.text_mask,
                                              batch.node_mask, gen)
        m = batch.node_mask.float()[..., None]
        return {"text": linear(h[:, :D], w["quantize.proj_text.weight"],
                               w["quantize.proj_text.bias"], pr),
                "graph": linear(h[:, D:], w["quantize.proj_graph.weight"],
                                w["quantize.proj_graph.bias"], pr),
                "shared_text": t_attn[:, 0],
                "shared_graph": (g_attn * m).sum(1) / m.sum(1).clamp(min=1.0)}

    @torch.no_grad()
    def eval_rows(self, batch: Batch) -> dict[str, torch.Tensor]:
        """The four paths' normalized rows [B, D] of the eval forward."""
        feats, nodes, h = self.encode(batch)
        return {k: l2_normalize(v) for k, v in self.path_inputs(feats, nodes, h, batch).items()}

    @torch.no_grad()
    def export_rows(self, batch: Batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The export's three outputs of the batch's codes: tokens and
        weights [B, 4, k] and the embedding [B, 4D], paths in export row
        order."""
        feats, nodes, h = self.encode(batch)
        rows = self.path_inputs(feats, nodes, h, batch)
        q = [self.quantize(rows[p], p) for p in PATHS]
        return (torch.stack([x["indices"] for x in q], 1),
                torch.stack([x["weights"] for x in q], 1),
                torch.cat([x["z_q_raw"] for x in q], -1))


# ------------------------------------------------------------- training --

def info_nce(q, k):
    n = q.shape[0]
    q, k = l2_normalize(q), l2_normalize(k)
    pos = (q * k).sum(-1) / INFO_NCE_TEMPERATURE
    sim = q @ k.T / INFO_NCE_TEMPERATURE
    neg = torch.where(torch.eye(n, dtype=torch.bool, device=q.device), NEG_INF, sim)
    return (torch.logsumexp(torch.cat([pos[:, None], neg], -1), -1) - pos).mean()


def alignment(a, b):
    return (a * b).sum(1).mean()


def orthogonal(a, b):
    return torch.sqrt(((a.T @ b) ** 2).sum())


def train_loss(model: MedTok, batch: Batch, gen: torch.Generator, train_cfg: dict):
    """(total loss, the six sweeps by name) of one training forward: clean
    and augmented graphs, cross-attention with dropout, six sweeps, vq +
    commit, InfoNCE / alignment / orthogonality terms. The usage FIFO takes
    the sweeps' indices in the order of ``FIFO_ORDER``."""
    D = model.cfg["quantizer"]["codebook_embed_dim"]
    feats, nodes, h = model.encode(batch)
    nodes_aug = model.graph(batch.node_ids, batch.edges_aug)
    h_aug = model.pooled(feats, nodes_aug, batch.node_mask)
    rows = model.path_inputs(feats, nodes, h, batch, gen)
    q_st = model.quantize(rows["shared_text"], "shared_text", train=True)
    q_sg = model.quantize(rows["shared_graph"], "shared_graph", train=True)
    w = model.w
    aug = {"text": linear(h_aug[:, :D], w["quantize.proj_text.weight"],
                          w["quantize.proj_text.bias"], model.prec),
           "graph": linear(h_aug[:, D:], w["quantize.proj_graph.weight"],
                           w["quantize.proj_graph.bias"], model.prec)}
    q_t = model.quantize(rows["text"], "text", train=True)
    q_g = model.quantize(rows["graph"], "graph", train=True)
    q_ta = model.quantize(aug["text"], "text", train=True)
    q_ga = model.quantize(aug["graph"], "graph", train=True)
    codebook = sum(q[k] for q in (q_st, q_sg, q_t, q_g) for k in ("vq_loss", "commit_loss"))
    x1n, x2n = l2_normalize(h[:, :D]), l2_normalize(h[:, D:])
    z1c, z2c = q_st["z_q"], q_sg["z_q"]
    beta, lamb = train_cfg["shared_loss_beta"], train_cfg["specific_loss_lamb"]
    shared = ((info_nce(z1c, z2c) - beta * alignment(x1n, x2n))
              + (info_nce(z2c, z1c) - beta * alignment(x2n, x1n)))
    z1, z1a, z2, z2a = q_t["z_q"], q_ta["z_q"], q_g["z_q"], q_ga["z_q"]
    specific = ((info_nce(torch.cat([z1, z2c], -1), torch.cat([z1a, z2c], -1))
                 + lamb * orthogonal(z1, z1c))
                + (info_nce(torch.cat([z2, z1c], -1), torch.cat([z2a, z1c], -1))
                   + lamb * orthogonal(z2, z2c)))
    sweeps = {"shared_text": q_st, "shared_graph": q_sg, "text": q_t, "graph": q_g,
              "text_aug": q_ta, "graph_aug": q_ga}
    return codebook + shared + specific, sweeps


class ClippedAdam:
    """Global-norm clip (scale max_norm / norm where the norm is not below
    max_norm), then Adam with bias corrections 1 - beta**t in float32."""

    def __init__(self, params: dict, cfg: dict):
        self.cfg = cfg
        self.t = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def clip(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        m = self.cfg["max_grad_norm"]
        scale = torch.where(norm < m, torch.ones_like(norm), m / norm)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        c = self.cfg
        b1, b2 = c["beta1"], c["beta2"]
        self.t += 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.t))
        for k, g in grads.items():
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + ADAM_EPS)
            params[k].sub_(c["lr"] * upd)


def epoch_codes(n: int, seed: int, epoch: int, batch: int, index: int) -> np.ndarray:
    """The codes of batch ``index`` of an epoch: a permutation of the n
    codes fixed by (seed, epoch), cut into whole batches."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order[index * batch:(index + 1) * batch]


def aug_seed(seed: int, epoch: int, index: int) -> int:
    """The edge-dropout seed of batch ``index`` of an epoch (one process)."""
    return (seed + 1) * 1_000_003 + epoch * 65_537 + index
