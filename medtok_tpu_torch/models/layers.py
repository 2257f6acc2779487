"""Shared layers (counterpart of ``medtok_tpu/models/layers.py``):
torch-parity multi-head attention (dense, or flash attention K3), the
bidirectional cross-attention stack, GCN and GAT message passing over
padded batched subgraphs, masked mean-pool, dropout from an explicit generator, the random
initialiser, and Linear / LayerNorm / Embedding that hold their parameters
in one dtype and compute in another.

Parameter names follow the JAX package's flax names, so ``convert.py`` maps
a flax tree onto ``state_dict`` keys one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from medtok_tpu_torch.ops.adj_count import adj_count_reference
from medtok_tpu_torch.ops.flash_attention import flash_attention
from medtok_tpu_torch.utils.profiling import span

NEG_INF = -1e9
FLASH_PRECISIONS = ("highest", "default")


class CastLinear(nn.Linear):
    """``nn.Linear`` with parameters held in ``param_dtype`` (default:
    ``dtype``) that computes in ``dtype``: input, weight and bias are cast
    to it first, as flax's ``Dense(dtype=...)`` casts its fp32 parameters.
    Training holds fp32 parameters (an Adam step of lr 1e-4 rounds away on
    a bf16 one); with both dtypes equal it is ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype=None, param_dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class CastLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with parameters in ``param_dtype`` computing for
    ``dtype`` activations. Where the two differ it runs as flax's LayerNorm
    over fp32 parameters: statistics, scale and shift in fp32 with the fp32
    parameters, the result rounded to ``dtype`` once."""

    def __init__(self, shape: int, eps: float = 1e-5, *, dtype=None,
                 param_dtype=None, device=None):
        super().__init__(shape, eps=eps, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype in (None, self.weight.dtype):
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.compute_dtype)


class CastEmbedding(nn.Embedding):
    """``nn.Embedding`` with the table in ``param_dtype``, looked up in
    ``dtype``: the table is cast, then gathered (flax ``Embed(dtype=...)``)."""

    def __init__(self, num: int, dim: int, *, dtype=None, param_dtype=None,
                 device=None):
        super().__init__(num, dim, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype or self.weight.dtype))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator`` (flax's
    form: kept values / (1 - rate), dropped ones 0). ``rate`` 0 is the
    identity."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def draw_seed(device, generator: torch.Generator | None = None) -> torch.Tensor:
    """The flash path's dropout seed: one int64 in [0, 2**31 - 1) drawn on
    ``device`` from ``generator``, where the JAX package draws it from its
    dropout key (the bits differ from JAX's by design). It stays a device
    tensor, so drawing it does not wait for the device."""
    return torch.randint(0, 2**31 - 1, (), generator=generator, device=device)


def resolve_use_flash(use_flash: bool | str, device) -> bool:
    """``use_flash`` True / False as given; "auto" is K3 on a CUDA device
    (the only path there whose attention runs a kernel of this package;
    the EHR shape's dense scores would not fit the card) and the dense
    path elsewhere, where K3 would run its dense plain version anyway."""
    if use_flash not in (True, False, "auto"):
        raise ValueError(f"use_flash must be True, False or 'auto', got {use_flash!r}")
    if use_flash == "auto":
        return torch.device(device).type == "cuda"
    return use_flash


class MultiheadAttention(nn.Module):
    """Batch-first MHA: q [B, Lq, E], k/v [B, Lk, E], key_mask [B, Lk] bool
    (True = valid). Logits and softmax in fp32, the rest in the layer dtype.

    ``dropout`` applies to the attention probabilities in training mode.
    ``use_flash`` (True / False / "auto") routes softmax(QK^T)V through K3
    (``ops/flash_attention.py``), which keeps no [B, H, L, L] tensor; "auto"
    takes it on CUDA tensors and the dense path on the CPU
    (``resolve_use_flash``). Under ``flash_precision`` "default", fp32 q/k/v enter K3 in
    bf16 (as the JAX package does); "highest" keeps fp32. The flash path's
    dropout seed and the dense path's dropout mask come from the
    ``generator`` passed to ``forward``."""

    def __init__(self, embed_dim: int, num_heads: int, *, dropout: float = 0.0,
                 use_flash: bool | str = False, flash_precision: str = "highest",
                 dtype=None, param_dtype=None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        resolve_use_flash(use_flash, "cpu")   # raises on anything else
        if flash_precision not in FLASH_PRECISIONS:
            raise ValueError(f"flash_precision must be one of {FLASH_PRECISIONS}, "
                             f"got {flash_precision!r}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash = use_flash
        self.flash_precision = flash_precision
        fk = {"dtype": dtype, "param_dtype": param_dtype, "device": device}
        self.q_proj = CastLinear(embed_dim, embed_dim, **fk)
        self.k_proj = CastLinear(embed_dim, embed_dim, **fk)
        self.v_proj = CastLinear(embed_dim, embed_dim, **fk)
        self.out_proj = CastLinear(embed_dim, embed_dim, **fk)

    def forward(self, q, k, v, key_mask=None, *,
                generator: torch.Generator | None = None,
                deterministic: bool | None = None):
        """``deterministic`` turns the dropout off (True) or on (False), as
        the cross-attention passes it (flax's switch); None, which the EHR
        model's encoder layer relies on, follows the module's training
        mode."""
        B, Lq, E = q.shape
        Lk = k.shape[1]
        H = self.num_heads
        Dh = E // H
        qh = self.q_proj(q).view(B, Lq, H, Dh).transpose(1, 2)
        kh = self.k_proj(k).view(B, Lk, H, Dh).transpose(1, 2)
        vh = self.v_proj(v).view(B, Lk, H, Dh).transpose(1, 2)
        if deterministic is None:
            deterministic = not self.training
        rate = 0.0 if deterministic else self.dropout
        if resolve_use_flash(self.use_flash, q.device):
            seed = draw_seed(q.device, generator) if rate > 0.0 else 0
            io_dtype = qh.dtype
            if self.flash_precision == "default" and io_dtype == torch.float32:
                qh, kh, vh = (t.to(torch.bfloat16) for t in (qh, kh, vh))
            out = flash_attention(qh, kh, vh, key_mask, dropout_rate=rate,
                                  dropout_seed=seed).to(io_dtype)
        else:
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(Dh)
            if key_mask is not None:
                logits = torch.where(key_mask[:, None, None, :], logits, NEG_INF)
            attn = dropout(torch.softmax(logits, dim=-1).to(q.dtype), rate, generator)
            out = torch.matmul(attn, vh)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, E))


class CrossAttentionLayer(nn.Module):
    """attn -> dropout -> residual add -> LayerNorm (eps 1e-5); no
    feed-forward. ``dropout`` applies when ``forward`` is called with
    ``deterministic=False`` (flax's switch; the default is off), to the
    attention probabilities and to the attention output, with masks drawn
    from the ``generator`` passed to ``forward``."""

    def __init__(self, embed_dim: int, num_heads: int, *, dropout: float = 0.1,
                 dtype=None, param_dtype=None, device=None):
        super().__init__()
        fk = {"dtype": dtype, "param_dtype": param_dtype, "device": device}
        self.dropout = dropout
        self.multihead_attn = MultiheadAttention(embed_dim, num_heads,
                                                 dropout=dropout, **fk)
        self.layer_norm = CastLayerNorm(embed_dim, eps=1e-5, **fk)

    def forward(self, query, key, value, key_mask=None, *,
                generator: torch.Generator | None = None, deterministic: bool = True):
        attn = self.multihead_attn(query, key, value, key_mask, generator=generator,
                                   deterministic=deterministic)
        if not deterministic:
            attn = dropout(attn, self.dropout, generator)
        return self.layer_norm(query + attn)


class CrossAttention(nn.Module):
    """Bidirectional cross-attention with one shared layer stack: v1 attends
    to the fixed v2 through every layer, then v2 to the fixed v1 through the
    same layers. It stays dense (no K3), as the JAX package's does."""

    def __init__(self, embed_dim: int, num_heads: int, layers: int = 2, *,
                 dropout: float = 0.1, dtype=None, param_dtype=None, device=None):
        super().__init__()
        self.num_layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}", CrossAttentionLayer(
                embed_dim, num_heads, dropout=dropout, dtype=dtype,
                param_dtype=param_dtype, device=device))

    def forward(self, v1, v2, v1_mask=None, v2_mask=None, *,
                generator: torch.Generator | None = None, deterministic: bool = True):
        stack = [getattr(self, f"layer_{i}") for i in range(self.num_layers)]
        kw = {"generator": generator, "deterministic": deterministic}
        v1_ = v1
        for layer in stack:
            v1_ = layer(v1_, v2, v2, v2_mask, **kw)
        v2_ = v2
        for layer in stack:
            v2_ = layer(v2_, v1, v1, v1_mask, **kw)
        return v1_, v2_


def gcn_propagate(x, edge_src, edge_dst, edge_weight):
    """Symmetric-normalized sum aggregation with a self-loop on every node.

    x [N, D] (already x @ W); edges flat-indexed into N (int64). Padded
    edges carry weight 0 and add nothing to degrees or messages.

    The scatter-adds are ``index_put_(accumulate=True)``: on CUDA that is a
    sorted, deterministic reduction that sums each destination in fp32 and
    rounds once, where ``index_add_`` adds with atomics in an order that
    changes from run to run (in bf16, rounding at every add), so the same
    code could get different tokens on two calls."""
    n = x.shape[0]
    w = edge_weight.float()
    deg = torch.ones(n, dtype=torch.float32, device=x.device).index_put_(
        (edge_dst,), w, accumulate=True)
    dinv = torch.rsqrt(deg)
    coef = (dinv[edge_src] * dinv[edge_dst] * w)[:, None].to(x.dtype)
    out = (dinv * dinv)[:, None].to(x.dtype) * x
    return out.index_put_((edge_dst,), coef * x[edge_src], accumulate=True)


def gcn_normalize(count: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A = (dinv_i * dinv_j) * Count + diag(dinv^2) with deg = 1 +
    Count.sum(j), from an fp32 [B, Ln, Ln] Count, which it overwrites."""
    deg = 1.0 + count.sum(dim=2)
    dinv = torch.rsqrt(deg)
    adj = count.mul_(dinv[:, :, None] * dinv[:, None, :])
    adj.diagonal(dim1=1, dim2=2).add_(dinv * dinv)
    return adj.to(dtype)


def gcn_norm_adj(edge_src, edge_dst, edge_weight, batch: int, num_nodes: int,
                 dtype=torch.float32):
    """Dense normalized adjacency [B, Ln, Ln]: A[b, i, j] is the coefficient
    of node j's message into node i (gcn_propagate's math, built once and
    shared by both conv layers).

    A = gcn_normalize(Count), with Count[b, i, j] the summed bf16-rounded
    weight of edges j -> i (the JAX package rounds the weights to bf16 in
    its one-hot Count). Edge indices are within-graph, chunked per graph.
    Count is built by ``index_put_`` (``ops/adj_count.py::
    adj_count_reference``); the hand kernels K5 and K5-lane compute the same
    Count and are timed against it by ``scripts/bench_adj.py``. The
    ``gcn_norm_adj`` range names the build in a torch.profiler trace."""
    with span("gcn_norm_adj"):
        count = adj_count_reference(edge_src, edge_dst, edge_weight, batch, num_nodes)
        return gcn_normalize(count, dtype)


class GCNConv(nn.Module):
    """PyG GCNConv: out = propagate(x @ W) + b. ``adj`` ([B, Ln, Ln] from
    gcn_norm_adj, x viewable as [B, Ln, D]) switches aggregation to a
    batched matmul."""

    def __init__(self, in_channels: int, out_channels: int, *, dtype=None,
                 param_dtype=None, device=None):
        super().__init__()
        self.lin = CastLinear(in_channels, out_channels, bias=False, dtype=dtype,
                              param_dtype=param_dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(out_channels, dtype=param_dtype or dtype,
                                             device=device))

    def forward(self, x, edge_src, edge_dst, edge_weight, adj=None):
        xw = self.lin(x)
        if adj is not None:
            B, Ln, _ = adj.shape
            out = torch.bmm(adj.to(x.dtype), xw.view(B, Ln, -1)).reshape(B * Ln, -1)
        else:
            out = gcn_propagate(xw, edge_src, edge_dst, edge_weight)
        return out + self.bias.to(x.dtype)


class GATAggregate(torch.autograd.Function):
    """out[i] = sum over edges e into i of alpha[e] * xw[src[e]]: alpha
    [E, H], xw [n, H, C] -> [n, H, C], the sums ``index_put_(accumulate=
    True)`` in xw's dtype. The [E, H, C] messages are made and dropped in
    the forward and made again in the backward (gradients: g_out[dst] . xw
    [src] for alpha, the scatter over src of g_out[dst] * alpha for xw), so
    autograd keeps no per-edge feature tensor between the two: at the top
    export bucket (1024 graphs of 512 nodes and 8192 edges, 4 heads of 128)
    one such tensor is 9 GB in bf16."""

    @staticmethod
    def forward(ctx, alpha, xw, src, dst):
        ctx.save_for_backward(alpha, xw, src, dst)
        return torch.zeros_like(xw).index_put_((dst,), alpha[..., None] * xw[src],
                                               accumulate=True)

    @staticmethod
    def backward(ctx, g_out):
        alpha, xw, src, dst = ctx.saved_tensors
        g_msg = g_out[dst]                                        # [E, H, C]
        g_alpha = (g_msg * xw[src]).sum(dim=-1) if ctx.needs_input_grad[0] else None
        g_xw = None
        if ctx.needs_input_grad[1]:
            g_xw = torch.zeros_like(xw).index_put_((src,), g_msg * alpha[..., None],
                                                   accumulate=True)
        return g_alpha, g_xw, None, None


class GATConv(nn.Module):
    """PyG GATConv: per-head additive attention over each node's incoming
    edges plus one self-loop a node (appended after the edges, weight 1).
    Scores are leaky-relu(a_src . xw_j + a_dst . xw_i) in fp32; padded edges
    (weight 0) score NEG_INF and their exp is multiplied by 0; the softmax
    takes a segment max and sum over ``dst`` (denominator clamped at
    1e-16); alpha is cast to the compute dtype before it weights the
    messages; heads are concatenated (or averaged), then the bias.

    The sums are ``index_put_(accumulate=True)``, deterministic on CUDA (a
    sorted reduction that sums each destination in fp32 and rounds once;
    ``index_add_``'s atomics would reorder bf16 sums between runs); the max
    is ``scatter_reduce("amax")``, which no order changes. As in JAX, the
    max carries a gradient (to the maximal entries, shared among ties), so
    a shift that cancels in the softmax cancels in the gradient too."""

    def __init__(self, in_channels: int, out_channels: int, num_heads: int = 4, *,
                 concat_heads: bool = True, negative_slope: float = 0.2,
                 dtype=None, param_dtype=None, device=None):
        super().__init__()
        H, C = num_heads, out_channels
        self.num_heads, self.out_channels = H, C
        self.concat_heads, self.negative_slope = concat_heads, negative_slope
        pdt = param_dtype or dtype
        self.lin = CastLinear(in_channels, H * C, bias=False, dtype=dtype,
                              param_dtype=param_dtype, device=device)
        self.att_src = nn.Parameter(torch.empty((H, C), dtype=pdt, device=device))
        self.att_dst = nn.Parameter(torch.empty((H, C), dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(H * C if concat_heads else C, dtype=pdt,
                                             device=device))
        with torch.no_grad():
            for p in (self.att_src, self.att_dst):
                glorot_uniform_(p)

    def forward(self, x, edge_src, edge_dst, edge_weight):
        """x [n, in]; edges flat-indexed into n (int64), weight 0 = padding."""
        n = x.shape[0]
        H, C = self.num_heads, self.out_channels
        xw = self.lin(x).view(n, H, C)
        dt = xw.dtype
        alpha_src = torch.einsum("nhc,hc->nh", xw, self.att_src.to(dt))
        alpha_dst = torch.einsum("nhc,hc->nh", xw, self.att_dst.to(dt))
        loop = torch.arange(n, device=x.device)
        src = torch.cat([edge_src.long(), loop])
        dst = torch.cat([edge_dst.long(), loop])
        w = torch.cat([edge_weight.float(),
                       torch.ones(n, dtype=torch.float32, device=x.device)])
        e = F.leaky_relu(alpha_src[src] + alpha_dst[dst], self.negative_slope).float()
        e = torch.where(w[:, None] > 0, e, NEG_INF)
        e_max = torch.full((n, H), NEG_INF, dtype=torch.float32, device=x.device
                           ).scatter_reduce(0, dst[:, None].expand(-1, H), e, "amax",
                                            include_self=True)
        e_exp = torch.exp(e - e_max[dst]) * w[:, None]
        denom = torch.zeros((n, H), dtype=torch.float32, device=x.device).index_put_(
            (dst,), e_exp, accumulate=True)
        alpha = (e_exp / torch.clamp(denom[dst], min=1e-16)).to(dt)
        out = GATAggregate.apply(alpha, xw, src, dst)
        out = out.reshape(n, H * C) if self.concat_heads else out.mean(dim=1)
        return out + self.bias.to(dt)


def global_mean_pool(x, mask):
    """Masked mean over the node axis: x [B, N, D], mask [B, N] -> [B, D]."""
    m = mask.to(x.dtype)
    s = (x * m[..., None]).sum(dim=1)
    cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    return s / cnt


#: parameters drawn from N(0, 1) by ``init_random_`` (flax ``normal(1.0)``)
UNIT_NORMAL_LEAVES = ("codebook", "miss_emb", "cls_emb")
#: the GAT attention vectors, drawn by ``glorot_uniform_``
GLOROT_LEAVES = ("att_src", "att_dst")


def glorot_uniform_(p: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``glorot_uniform`` on a 2-D [fan_in, fan_out] tensor, in place:
    U(-l, l) with l = sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    return p.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, in the families the JAX package's
    flax initializers use: N(0, 1/fan_in) for dense kernels (the last axis;
    also each of stacked experts' [n, out, in]), N(0, 1/dim) for
    embedding tables, N(0, 1) for the codebook and the EHR model's raw
    embedding rows, glorot-uniform for the GAT attention vectors, zero
    biases, unit LayerNorm scales."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in UNIT_NORMAL_LEAVES:
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf in GLOROT_LEAVES:
            glorot_uniform_(p, generator)
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
    return model
