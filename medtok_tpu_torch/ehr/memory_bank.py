"""Patient-embedding memory bank + contrastive loss (counterpart of
``medtok_tpu/ehr/memory_bank.py``; torch functions on the device of their
tensors).

- ``contrastive_loss``: InfoNCE over cosine similarities with in-batch
  negatives (the diagonal dropped), optional positive-view negatives, and
  detached memory-bank negatives put first among the negatives; the
  positive sits at logit column 0.
- ``update_memory_bank``: l2-normalize new embeddings and FIFO-append them,
  capped at the bank's size. The bank is a fixed [size, D] ring buffer plus
  a monotone write count, as in the JAX package. With ``group`` (a
  ``torch.distributed`` process group) the new rows are first gathered from
  every rank in rank order.

Reference training does not use the bank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MemoryBankState(NamedTuple):
    buffer: torch.Tensor   # [size, D] l2-normalized rows (stale slots = junk)
    count: torch.Tensor    # scalar int32, total rows ever written


def init_memory_bank(size: int, dim: int, dtype=torch.float32, *,
                     device: str | torch.device = "cpu") -> MemoryBankState:
    return MemoryBankState(
        buffer=torch.zeros((size, dim), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def update_memory_bank(state: MemoryBankState, new_embeddings: torch.Tensor, *,
                       group=None) -> MemoryBankState:
    """FIFO-append the (gathered, normalized) rows into the ring: after the
    cap the bank holds the most recent ``size`` rows, the oldest at ring
    position ``count % size``."""
    if group is not None:
        import torch.distributed as dist

        parts = [torch.empty_like(new_embeddings)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, new_embeddings.contiguous(), group=group)
        new_embeddings = torch.cat(parts, dim=0)
    new = _l2norm(new_embeddings.detach().to(state.buffer.dtype))
    size = state.buffer.shape[0]
    n = new.shape[0]
    if n > size:  # only the last `size` rows survive the cap
        new = new[n - size:]
        n = size
    slots = torch.remainder(state.count + torch.arange(n, dtype=torch.int32,
                                                       device=new.device), size)
    buffer = state.buffer.clone()
    buffer[slots.long()] = new
    return MemoryBankState(buffer=buffer, count=state.count + n)


def bank_valid_mask(state: MemoryBankState) -> torch.Tensor:
    """[size] bool — which slots hold real (ever-written) rows."""
    size = state.buffer.shape[0]
    return torch.arange(size, device=state.buffer.device) < torch.clamp(state.count, max=size)


def _drop_diagonal(x: torch.Tensor) -> torch.Tensor:
    """[B, B] -> [B, B-1]: each row without its diagonal entry, in order."""
    B = x.shape[0]
    keep = ~torch.eye(B, dtype=torch.bool, device=x.device)
    return x[keep].reshape(B, B - 1)


def contrastive_loss(anchor: torch.Tensor, pos: torch.Tensor | None = None,
                     bank: MemoryBankState | None = None, *,
                     temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE with the logit layout: column 0 = positive cosine
    similarity; negatives = [memory bank | within-anchor (diagonal dropped)
    | with-pos (diagonal dropped)]."""
    a = _l2norm(anchor)
    if pos is not None:
        p = _l2norm(pos)
        pos_sim = torch.sum(a * p, dim=-1) / temperature
    else:
        pos_sim = torch.sum(a * a, dim=-1) / temperature
    negs = [_drop_diagonal((a @ a.T) / temperature)]
    if pos is not None:
        negs.append(_drop_diagonal((a @ p.T) / temperature))
    if bank is not None:
        mem = (a @ bank.buffer.detach().T) / temperature
        # stale slots must not act as negatives
        mem = torch.where(bank_valid_mask(bank)[None, :], mem,
                          torch.full_like(mem, float("-inf")))
        negs.insert(0, mem)
    logits = torch.cat([pos_sim[:, None]] + negs, dim=-1)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])
