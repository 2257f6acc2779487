"""EMA codebook helpers (counterpart of ``medtok_tpu/ops/ema.py``):
the moving-average updates and the k-means that initialises the codebook.

The sums of ``kmeans`` are ``index_put_(accumulate=True)``: deterministic
on CUDA (a sorted reduction in fp32), where ``index_add_`` adds with
atomics in an order that changes between runs.
"""

from __future__ import annotations

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
