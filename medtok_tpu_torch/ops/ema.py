"""EMA codebook helpers (counterpart of ``medtok_tpu/ops/ema.py``):
the moving-average updates, the k-means that initialises the codebook, and
the stand-alone EMA quantizers (``norm_ema_quantize``, ``lookup_quantize``,
``revival_quantize`` and their state).

The sums of ``kmeans`` are ``index_put_(accumulate=True)``: deterministic
on CUDA (a sorted reduction in fp32), where ``index_add_`` adds with
atomics in an order that changes between runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from medtok_tpu_torch.ops.vq import l2_normalize, squared_distance


def ema_update(moving_avg: torch.Tensor, new: torch.Tensor, decay: float) -> torch.Tensor:
    return moving_avg * decay + new * (1.0 - decay)


def norm_ema_update(moving_avg: torch.Tensor, new: torch.Tensor,
                    decay: float) -> torch.Tensor:
    return l2_normalize(ema_update(moving_avg, new, decay))


def kmeans_init_indices(n: int, num_clusters: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """The sample rows of the initial means, drawn on the CPU from
    ``generator`` (a CPU generator; default seed 0): without replacement
    when ``n >= num_clusters``, else with replacement, as the JAX
    ``kmeans`` draws them (its bits differ by design)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if n >= num_clusters:
        return torch.randperm(n, generator=generator)[:num_clusters]
    return torch.randint(0, n, (num_clusters,), generator=generator)


def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           use_cosine_sim: bool = False, *, generator: torch.Generator | None = None,
           init_idx: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(means [C, D], bins [C]) of Lloyd's iterations over ``samples`` [n,
    D]. The initial means are ``samples[init_idx]``; without ``init_idx``
    they are drawn by ``kmeans_init_indices(generator)`` on the CPU, so the
    card and the CPU start from the same means. Each sample goes to its
    most similar mean (dot product under ``use_cosine_sim``, else minus the
    squared distance), the lowest index on ties; an empty cluster keeps its
    mean; cosine means are re-normalised. ``bins`` are the last
    iteration's counts (zeros when ``num_iters`` is 0)."""
    n, d = samples.shape
    if init_idx is None:
        init_idx = kmeans_init_indices(n, num_clusters, generator)
    means = samples[init_idx.to(samples.device).long()]
    bins = torch.zeros(num_clusters, dtype=torch.float32, device=samples.device)
    ones = torch.ones(n, dtype=torch.float32, device=samples.device)
    for _ in range(num_iters):
        if use_cosine_sim:
            sims = samples @ means.T
        else:
            sims = -squared_distance(samples, means)
        buckets = torch.argmax(sims, dim=-1)
        bins = torch.zeros(num_clusters, dtype=torch.float32, device=samples.device
                           ).index_put_((buckets,), ones, accumulate=True)
        zero = bins == 0
        sums = torch.zeros(num_clusters, d, dtype=samples.dtype, device=samples.device
                           ).index_put_((buckets,), samples, accumulate=True)
        new_means = sums / torch.where(zero, 1.0, bins)[:, None]
        if use_cosine_sim:
            new_means = l2_normalize(new_means)
        means = torch.where(zero[:, None], means, new_means)
    return means, bins


# ------------------------------------------------------- EmbeddingEMA state --
# The stand-alone quantizers of the JAX module (its ``EmbeddingEMAState`` ..
# ``revival_quantize``): state is a NamedTuple of tensors and every update
# returns a new one. ``jax.random`` draws cannot be reproduced in torch, so
# each draw comes from an explicit ``torch.Generator`` or, where a caller
# wants given draws (the tests feed the JAX ones), from an argument.


class EmbeddingEMAState(NamedTuple):
    weight: torch.Tensor        # [C, D]
    cluster_size: torch.Tensor  # [C]
    embed_avg: torch.Tensor     # [C, D]
    initted: torch.Tensor       # scalar bool


def embedding_ema_init(num_tokens: int, dim: int, *, kmeans_init: bool = True,
                       init_weight=None, generator: torch.Generator | None = None,
                       device=None) -> EmbeddingEMAState:
    """The codebook ``init_weight`` (initialised), or zeros waiting for
    ``maybe_kmeans_init`` (``kmeans_init``), or l2-unit rows drawn from
    ``generator``; ``embed_avg`` starts as the weight, ``cluster_size`` at
    zeros."""
    if init_weight is not None:
        w = torch.as_tensor(init_weight, dtype=torch.float32, device=device)
        initted = True
    elif kmeans_init:
        w = torch.zeros(num_tokens, dim, dtype=torch.float32, device=device)
        initted = False
    else:
        w = l2_normalize(torch.randn(num_tokens, dim, generator=generator, device=device))
        initted = True
    return EmbeddingEMAState(
        weight=w, cluster_size=torch.zeros(num_tokens, dtype=torch.float32, device=w.device),
        embed_avg=w, initted=torch.tensor(initted, device=w.device))


def maybe_kmeans_init(state: EmbeddingEMAState, data: torch.Tensor, *,
                      generator: torch.Generator | None = None,
                      init_idx: torch.Tensor | None = None) -> EmbeddingEMAState:
    """On the first batch (``state.initted`` false) the cosine k-means of
    ``data`` [n, D] (10 iterations; initial rows ``init_idx`` or drawn by
    ``kmeans_init_indices(generator)``) becomes the weight and its last
    counts the cluster sizes; an initialised state comes back as it is,
    without running the k-means."""
    if bool(state.initted):
        return state
    means, bins = kmeans(data, state.weight.shape[0], 10, use_cosine_sim=True,
                         generator=generator, init_idx=init_idx)
    return EmbeddingEMAState(means, bins, state.embed_avg,
                             torch.tensor(True, device=state.initted.device))


def weight_update(state: EmbeddingEMAState, eps: float = 1e-5) -> EmbeddingEMAState:
    """Laplace-smoothed write: weight = embed_avg / smoothed cluster size."""
    c = state.cluster_size
    n = c.sum()
    smoothed = (c + eps) / (n + c.shape[0] * eps) * n
    return state._replace(weight=state.embed_avg / smoothed[:, None])


def assignment_stats(flat: torch.Tensor, indices: torch.Tensor, C: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bins [C], embed_sum [C, D]): each codeword's count of assigned rows
    and the sum of their features, with ``index_put_`` (deterministic on
    CUDA, and fp32 where a one-hot matmul could run in TF32). Shared by the
    quantizer's EMA write and the stand-alone quantizers."""
    bins = torch.zeros(C, dtype=torch.float32, device=flat.device).index_put_(
        (indices,), torch.ones_like(indices, dtype=torch.float32), accumulate=True)
    embed_sum = torch.zeros(C, flat.shape[1], dtype=torch.float32, device=flat.device
                            ).index_put_((indices,), flat, accumulate=True)
    return bins, embed_sum


def norm_ema_weight(weight: torch.Tensor, bins: torch.Tensor, embed_sum: torch.Tensor,
                    decay: float) -> torch.Tensor:
    """The norm-EMA write: each row toward the normalised mean of its
    features; a row that took none keeps its codeword."""
    zero = bins == 0
    mean = l2_normalize(embed_sum / torch.where(zero, 1.0, bins)[:, None])
    return norm_ema_update(weight, torch.where(zero[:, None], weight, mean), decay)


def _nearest_rows(flat: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int64 [N]: each row's nearest codeword by squared L2, the lowest
    index on ties (``argmin``'s rule): kernel K1 at k = 1 on CUDA tensors
    (it launches or raises), its plain version on CPU tensors."""
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    _, idx = fused_topk_l2(flat.detach().contiguous(), weight.detach().float().contiguous(),
                           k=1)
    return idx[:, 0].long()


class NormEMAOut(NamedTuple):
    z_q: torch.Tensor
    loss: torch.Tensor
    indices: torch.Tensor
    state: EmbeddingEMAState
    cluster_size: torch.Tensor  # the running usage EMA (a buffer of its own)


def norm_ema_quantize(z: torch.Tensor, state: EmbeddingEMAState,
                      cluster_size: torch.Tensor, *, beta: float = 0.25,
                      decay: float = 0.99, train: bool = True, dp=None) -> NormEMAOut:
    """Argmin VQ of z [..., D] (l2-normalised) against ``state.weight``
    (``_nearest_rows``: K1 at k = 1 on CUDA) with the norm-EMA codebook
    write in training. ``dp`` (a ``parallel.mesh.DataParallel``, or None):
    the bin counts, and in training the feature sums, are summed over its
    dp axis before the EMA write, so every rank writes the codebook of the
    whole batch. The usage EMA ``cluster_size`` moves in eval too."""
    z_n = l2_normalize(z.float())
    flat = z_n.reshape(-1, z_n.shape[-1])
    indices = _nearest_rows(flat, state.weight)
    z_q = state.weight[indices].reshape(z_n.shape)
    bins, embed_sum = assignment_stats(flat.detach(), indices, state.weight.shape[0])
    if dp is not None:
        dp.all_reduce_sum_([bins, embed_sum] if train else [bins], axis="dp")
    new_cluster = ema_update(cluster_size, bins, decay)
    new_state = state
    if train:
        new_state = state._replace(weight=norm_ema_weight(state.weight, bins, embed_sum,
                                                           decay))
    loss = beta * ((z_q.detach() - z_n) ** 2).mean()
    return NormEMAOut(z_n + (z_q - z_n).detach(), loss, indices, new_state, new_cluster)


def lookup_quantize(state: EmbeddingEMAState, indices: torch.Tensor,
                    z: torch.Tensor | None = None, *, beta: float = 0.25
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode given indices; with z, the commitment loss against it (no
    codebook update)."""
    z_q = state.weight[indices]
    if z is None:
        return z_q, torch.zeros((), dtype=torch.float32, device=z_q.device)
    return z_q, beta * ((z_q - z.detach()) ** 2).mean()


# --------------------------------------------------------- CVectorQuantiser --

class FeaturePoolState(NamedTuple):
    features: torch.Tensor   # [pool, D]
    num: torch.Tensor        # scalar int


def feature_pool_init(pool_size: int, dim: int, *, generator: torch.Generator | None = None,
                      device=None, uniform: torch.Tensor | None = None) -> FeaturePoolState:
    """A pool of ``(u * 2 - 1) / pool_size`` for u uniform in [0, 1):
    ``uniform`` [pool, D] if given, else drawn from ``generator``."""
    if uniform is None:
        uniform = torch.rand(pool_size, dim, generator=generator, device=device)
    f = (uniform.to(device=device, dtype=torch.float32) * 2 - 1) / pool_size
    return FeaturePoolState(f, torch.zeros((), dtype=torch.int64, device=f.device))


def feature_pool_query(state: FeaturePoolState, features: torch.Tensor, *,
                       generator: torch.Generator | None = None,
                       draw: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, FeaturePoolState]:
    """The pool after taking ``features`` [n, D], and the new state: at n >=
    pool a pool of ``features[draw]`` (``draw``: pool rows drawn with
    replacement), else ``features`` written over the pool's slots ``draw``
    (n distinct slots). ``draw`` is drawn from ``generator`` unless
    given."""
    pool, n = state.features.shape[0], features.shape[0]
    dev = features.device
    if n >= pool:
        if draw is None:
            draw = torch.randint(0, n, (pool,), generator=generator, device=dev)
        new = features[draw.to(dev).long()]
        return new, FeaturePoolState(new, torch.full_like(state.num, pool))
    if draw is None:
        draw = torch.randperm(pool, generator=generator, device=dev)[:n]
    new = state.features.clone()
    new[draw.to(dev).long()] = features.to(new.dtype)
    return new, FeaturePoolState(new, torch.clamp(state.num + n, max=pool))


class RevivalOut(NamedTuple):
    z_q: torch.Tensor
    loss: torch.Tensor
    contra_loss: torch.Tensor
    indices: torch.Tensor
    state: EmbeddingEMAState
    embed_prob: torch.Tensor
    pool: FeaturePoolState


ANCHORS = ("closest", "random", "probrandom")


def revival_quantize(z: torch.Tensor, state: EmbeddingEMAState, embed_prob: torch.Tensor,
                     pool: FeaturePoolState, *, beta: float = 0.25, decay: float = 0.99,
                     anchor: str = "closest", contras_loss: bool = False,
                     train: bool = True, dp=None, generator: torch.Generator | None = None,
                     draw: torch.Tensor | None = None) -> RevivalOut:
    """Dead-code-revival VQ: argmax of the negative squared L2 [N, C]
    (one matmul: the anchors need the whole affinity), then in training the
    norm-EMA write (bins and feature sums summed over ``dp``'s dp axis
    first), the EMA of this batch's assignment shares, and each codeword
    pulled toward an anchor feature by exp(-share * C * 10 / (1 - decay) -
    1e-3): its most similar sample (``closest``), a pool sample
    (``random``: ``feature_pool_query``) or a sample drawn by the softmax of
    its affinities (``probrandom``). ``draw`` gives the random draw (the
    pool's rows or slots, or the sample of each codeword) in place of one
    from ``generator``. ``contras_loss`` adds the contrastive term of each
    codeword's nearest samples against its farthest half, returned apart.
    As in the JAX function the shares, the anchors and the contrastive term
    are this rank's own."""
    if anchor not in ANCHORS:
        raise ValueError(anchor)
    z_n = l2_normalize(z.float())
    flat = z_n.reshape(-1, z_n.shape[-1])
    sg = flat.detach()
    C = state.weight.shape[0]
    d = -squared_distance(sg, state.weight)                      # [N, C]
    indices = torch.argmax(d, dim=1)
    z_q = state.weight[indices].reshape(z_n.shape)

    new_state, new_prob, new_pool = state, embed_prob, pool
    contra = torch.zeros((), dtype=torch.float32, device=z_n.device)
    if train:
        bins, embed_sum = assignment_stats(sg, indices, C)
        avg_probs = bins / sg.shape[0]
        if dp is not None:
            dp.all_reduce_sum_([bins, embed_sum], axis="dp")
        weight = norm_ema_weight(state.weight, bins, embed_sum, decay)
        new_prob = ema_update(embed_prob, avg_probs, decay)
        if anchor == "closest":
            random_feat = sg[torch.argmax(d, dim=0)]
        elif anchor == "random":
            random_feat, new_pool = feature_pool_query(pool, sg, generator=generator,
                                                       draw=draw)
        else:
            if draw is None:
                probs = torch.softmax(d.T, dim=1)                # [C, N]
                draw = torch.multinomial(probs + 1e-12, 1, generator=generator)[:, 0]
            random_feat = sg[draw.to(sg.device).long()]
        revive = torch.exp(-(new_prob * C * 10) / (1 - decay) - 1e-3)[:, None]
        new_state = state._replace(weight=weight * (1 - revive) + random_feat * revive)
        if contras_loss:
            n = sg.shape[0]
            sort_d = torch.sort(d, dim=0).values                 # ascending per codeword
            dis_pos = sort_d[-max(1, n // C):].mean(dim=0, keepdim=True)
            logits = torch.cat([dis_pos, sort_d[: n // 2]], dim=0).T / 0.07
            contra = (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()

    loss = beta * ((z_q.detach() - z_n) ** 2).mean()
    return RevivalOut(z_n + (z_q - z_n).detach(), loss, contra, indices, new_state,
                      new_prob, new_pool)
