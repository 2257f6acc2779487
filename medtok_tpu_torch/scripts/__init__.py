"""A/B entry points of the port (counterparts of the JAX package's
``scripts/``): ``bench_adj`` times the dense-adjacency Count builds,
``profile_bert`` splits the packed BERT forward into its parts and
``profile_wide`` splits K1's and K3's wide routes by kernel. Each runs
as ``python -m medtok_tpu_torch.scripts.<name>`` and has ``main(argv) ->
dict``.
"""

from __future__ import annotations

import time

import torch


def timed(fn, trials: int, dev: torch.device, iters: int = 1) -> float:
    """ms of fn(): one warm-up call, then the least over ``trials`` timings
    of the mean of ``iters`` back-to-back calls. CUDA events around the
    calls on the card, the host clock on the CPU."""
    cuda = dev.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(trials):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        times.append(ms / iters)
    return min(times)
