"""PyTorch + CUDA port of the medtok_tpu framework (the eval export and EHR
training slices).

The JAX package ``medtok_tpu`` stays the reference; this package keeps its
own copy of every piece of host code it needs and imports nothing from it.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without a GPU, ``device=None`` raises rather than carrying on on the CPU:
    a run that silently moved off the card would report CPU numbers as the
    port's."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
