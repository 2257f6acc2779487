"""Soft top-k vector quantization and the codebook-usage FIFO (counterpart
of ``medtok_tpu/ops/vq.py``).

- squared-L2 distance ``|x|^2 + |e|^2 - 2 x e^T`` in fp32;
- the k smallest distances with lowest-index tie-break, from a stable
  (value, index) sort (``torch.topk`` gives no tie order);
- weights ``softmax(-d_topk)``; the quantized vector is the weighted sum of
  the normalized codewords, passed through the straight-through form
  ``z + sg(z_q - z)`` (``sg`` = ``detach``): its value is z_q, its gradient
  flows to z only;
- in training, the vq loss ``mean((sg(z) - z_q)^2)`` and the commit loss
  ``beta * mean((z - sg(z_q))^2)`` against the unnormalized z;
- region-restricted sweeps: text uses rows [0, n//3), graph rows
  [n - n//3, n); indices stay region-local;
- the usage FIFO: the last ``buffer_size`` selected ids and each id's
  multiplicity in them, so the share of the codebook in use is
  ``sum(counts > 0) / n_e`` without a unique over the buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TOPK_BACKENDS = ("auto", "pallas", "xla", "grouped", "two_pass")


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(|x|, eps), as torch.nn.functional.normalize(p=2)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def squared_distance(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Pairwise squared-L2 distance in fp32: x [B, D], e [N, D] -> [B, N]."""
    x = x.float()
    e = e.float()
    x_sq = (x * x).sum(dim=1, keepdim=True)
    e_sq = (e * e).sum(dim=1)
    return x_sq + e_sq[None, :] - 2.0 * (x @ e.T)


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries per row, lowest index
    first on ties."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def distance_topk(
    z_n: torch.Tensor, e_n: torch.Tensor, k: int, *, backend: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest squared-L2 distances (values, int64 indices) of z_n rows
    against e_n rows.

    On CUDA every backend routes to kernel K1 for the indices; the values
    are then recomputed from the gathered codewords, as the JAX package's
    Pallas branch does, so ``softmax(-values)`` matches it. On the CPU every
    backend runs the plain version."""
    if backend not in TOPK_BACKENDS:
        raise ValueError(f"unknown topk_backend {backend!r}")
    if z_n.device.type == "cpu":
        return topk_smallest(squared_distance(z_n, e_n), k)
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    # the kernel takes no gradient: the values are recomputed below
    _, idx = fused_topk_l2(z_n.detach(), e_n.detach(), k=k)
    idx = idx.long()
    g = e_n[idx]  # [B, k, D]
    vals = (
        (z_n * z_n).sum(dim=-1, keepdim=True)
        + (g * g).sum(dim=-1)
        - 2.0 * torch.einsum("bd,bkd->bk", z_n, g)
    )
    return vals, idx


def region_slice(codebook: torch.Tensor, region: str | None) -> torch.Tensor:
    """Codebook rows of a region, as a view: text -> [0, n//3), graph ->
    [n - n//3, n), None -> all rows."""
    n = codebook.shape[0]
    third = n // 3
    if region == "text":
        return codebook[:third]
    if region == "graph":
        return codebook[n - third:]
    if region is None:
        return codebook
    raise ValueError(f"unknown region {region!r}")


class QuantizeOut(NamedTuple):
    z_q: torch.Tensor      # [B, D] quantized output (straight-through form)
    indices: torch.Tensor  # [B, k] int64 codeword ids (region-local)
    weights: torch.Tensor  # [B, k] softmax(-d) assignment weights
    z_q_raw: torch.Tensor  # [B, D] fp32 weighted codeword sum (no straight-through)
    vq_loss: torch.Tensor | None      # scalar in training, None in eval
    commit_loss: torch.Tensor | None  # scalar in training, None in eval


def soft_topk_quantize(
    z: torch.Tensor,
    codebook: torch.Tensor,
    *,
    k: int = 5,
    beta: float = 0.25,
    l2_norm: bool = True,
    train: bool = False,
    region: str | None = None,
    backend: str = "auto",
) -> QuantizeOut:
    """Soft top-k quantization of ``z`` against ``codebook`` rows.

    The codebook is normalized whole and the region taken as a row view of
    it (normalization is per row, so this equals normalizing the slice), so
    the sweep reads the region in place. ``train`` adds the vq and commit
    losses."""
    z32 = z.float()
    if l2_norm:
        e_n = l2_normalize(codebook.float())
        z_n = l2_normalize(z32)
    else:
        e_n = codebook.float()
        z_n = z32
    e_r = region_slice(e_n, region)
    values, indices = distance_topk(z_n, e_r, k, backend=backend)
    weights = torch.softmax(-values, dim=-1)
    gathered = e_r[indices]  # [B, k, D]
    z_q_raw = (weights[..., None] * gathered).sum(dim=1)
    vq_loss = commit_loss = None
    if train:
        vq_loss = ((z32.detach() - z_q_raw) ** 2).mean()
        commit_loss = beta * ((z32 - z_q_raw.detach()) ** 2).mean()
    z_q = z32 + (z_q_raw - z32).detach()
    return QuantizeOut(z_q.to(z.dtype), indices, weights, z_q_raw, vq_loss, commit_loss)


# --------------------------------------------------------------------------
# Codebook usage (vector_quantization_soft_one_new.py:118, 219-236 of the
# reference)
# --------------------------------------------------------------------------

def usage_counts_init(n_e: int, buffer_size: int, device=None) -> torch.Tensor:
    """Multiplicity of each codebook id in the all-zero FIFO buffer: id 0
    appears ``buffer_size`` times."""
    counts = torch.zeros(n_e, dtype=torch.int32, device=device)
    counts[0] = buffer_size
    return counts


def _count_add(counts: torch.Tensor, ids: torch.Tensor, delta: int) -> torch.Tensor:
    """counts[ids] += delta for each id, repeats included. Negative ids
    count from the end and ids still outside [0, n_e) add nothing, as the
    JAX scatter's ``mode="drop"`` has them. The counts are integers, so the
    atomics of ``scatter_add_`` sum them to the same total in any order;
    ``index_put_(accumulate=True)`` would walk each run of equal ids
    serially (a buffer's first evictions are all id 0)."""
    n = counts.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    keep = (ids >= 0) & (ids < n)
    vals = torch.where(keep, delta, 0).to(counts.dtype)
    return counts.scatter_add_(0, torch.where(keep, ids, 0).long(), vals)


def usage_update(buffer: torch.Tensor, counts: torch.Tensor,
                 new_indices: torch.Tensor, n_e: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FIFO-shift ``buffer`` by len(new_indices), append them, and return
    (new buffer, new counts, share of the codebook present in the buffer).

    ``counts`` holds the multiplicity of every id in the buffer: evicted
    head entries decrement it, appended ones increment it, so the distinct
    count is ``sum(counts > 0)``. The inputs are not modified."""
    flat = new_indices.reshape(-1).to(buffer.dtype)
    cur = flat.shape[0]
    evicted = buffer[:cur]
    new_buffer = torch.cat([buffer[cur:], flat])
    new_counts = _count_add(counts.clone(), evicted, -1)
    new_counts = _count_add(new_counts, flat, 1)
    usage = (new_counts > 0).sum().float() / float(n_e)
    return new_buffer, new_counts, usage
