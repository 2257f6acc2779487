"""Stochastic depth (drop-path): per-sample residual-branch dropout
(counterpart of ``medtok_tpu/ops/drop_path.py``).

One Bernoulli(keep) draw per sample, a mask of shape (B, 1, ..., 1), so a
sample's whole branch is dropped at once; the 1 / keep rescale keeps the
branch's expected value. The draw comes from an explicit ``torch.Generator``
on ``x``'s device (the JAX function's explicit key).
"""

from __future__ import annotations

import torch
from torch import nn


def drop_path(x: torch.Tensor, drop_prob: float, *, generator: torch.Generator | None = None,
              deterministic: bool = False, scale_by_keep: bool = True) -> torch.Tensor:
    """Zero each sample of ``x`` with probability ``drop_prob`` (kept where a
    uniform draw from ``generator`` is below 1 - drop_prob), the kept ones
    divided by the keep probability in ``x``'s dtype (``scale_by_keep``).
    ``drop_prob`` 0 or ``deterministic`` (eval) is the identity; otherwise
    ``drop_prob`` must lie in [0, 1)."""
    if drop_prob == 0.0 or deterministic:
        return x
    if not 0.0 <= drop_prob < 1.0:
        raise ValueError(f"drop_prob must be in [0, 1), got {drop_prob}")
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = (torch.rand(shape, generator=generator, device=x.device) < keep_prob).to(x.dtype)
    if scale_by_keep:
        mask = mask / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return x * mask


class DropPath(nn.Module):
    """Module form: ``drop_path`` in training mode, the identity under
    ``eval()`` (the JAX module's ``deterministic=True``). Draws from
    ``generator`` (the default generator of ``x``'s device if None)."""

    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale_by_keep = scale_by_keep
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        return drop_path(x, self.drop_prob, generator=self.generator,
                         scale_by_keep=self.scale_by_keep)

    def extra_repr(self) -> str:
        return f"drop_prob={self.drop_prob}"
