"""Device time of four wide routes, call by call and kernel by kernel: K1's
(``fused_topk_l2`` at D above 256 or k above 8) at z [4096, 320] against
21000 codewords, k 9, 5, 64, 17 and 1000 (the last three above the register
lists: the distances written, then the radix select, whose ms the split by
kernel name shows), with fp32 matmul + ``torch.topk`` at k 64 beside it,
and K3's bf16 forward, dq and dk / dv (``flash_attention_fwd``,
``flash_attention_dq``, ``flash_attention_dkv`` at a head width above 256)
at [8*2, 1100, 320],
every key valid, dropout 0.5 — the shapes ``chip_smoke.py::wide_times``
times them at — and at EHRTrainer's [16*2, 2003, 320] with each row's valid
keys a prefix of 500-2002.

    python -m medtok_tpu_torch.scripts.profile_wide [--device cuda] [--calls 5]

For each case: the mean ms of a call (CUDA events, the least of three runs
of ``--calls`` calls) and, from one torch.profiler window over ``--calls``
calls, each CUDA kernel's device ms a call by name. It reads only the
wrappers' public names, so it runs against any version of the package on
``PYTHONPATH`` (an older tree's kernels included). Prints one JSON object.
``--device cpu`` runs the plain versions at a small shape (no profile).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from medtok_tpu_torch.ops import flash_attention as fa
from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
from medtok_tpu_torch.scripts import timed

SEED = 20261018


def kernel_ms(fn, calls: int) -> dict:
    """Device ms a call of each CUDA kernel fn() launches, by name, from one
    profiled window of ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def cases(dev: torch.device) -> dict:
    """name -> a call, at the card's shapes or, on the CPU, small ones."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    small = dev.type == "cpu"
    B, N, D = (64, 300, 320) if small else (4096, 21000, 320)
    z = torch.nn.functional.normalize(torch.randn(B, D, generator=gen, device=dev), dim=1)
    e = torch.nn.functional.normalize(torch.randn(N, D, generator=gen, device=dev), dim=1)
    calls = {f"K1 wide z [{B}, {D}] x e [{N}, {D}], k {k}":
             (lambda k=k: fused_topk_l2(z, e, k=k)) for k in (9, 5, 64, 17, min(1000, N))}

    def matmul_topk(k=64):  # the library's call for K1's function
        d = (z * z).sum(1, keepdim=True) + (e * e).sum(1)[None] - 2.0 * (z @ e.T)
        return torch.topk(d, k, dim=1, largest=False)

    calls[f"library fp32 matmul + torch.topk z [{B}, {D}] x e [{N}, {D}], k 64"] = matmul_topk
    Dh = 320
    kw = dict(sm_scale=1.0 / math.sqrt(Dh), dropout_rate=0.5, dropout_seed=SEED)
    for Bf, L, ehr in ((1, 100, False), (1, 160, True)) if small else \
            ((8, 1100, False), (16, 2003, True)):
        q, k, v, do = (torch.randn(Bf, 2, L, Dh, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        lens = torch.randint(L // 4, L, (Bf, 1), generator=gen, device=dev) if ehr else \
            torch.full((Bf, 1), L, device=dev)
        mask = torch.arange(L, device=dev)[None] < lens  # [Bf, L]
        out, lse = fa.flash_attention_fwd(q, k, v, mask, **kw)
        bwd = (q, k, v, mask, lse, (do.float() * out.float()).sum(-1), do)
        shape = f"bf16 [{Bf}*2, {L}, {Dh}], " + (
            "keys a prefix of each row" if ehr else "every key valid") + ", dropout 0.5"
        calls[f"K3-fwd wide {shape}"] = lambda bwd=bwd: fa.flash_attention_fwd(*bwd[:4], **kw)
        calls[f"K3-dq wide {shape}"] = lambda bwd=bwd: fa.flash_attention_dq(*bwd, **kw)
        calls[f"K3-dkv wide {shape}"] = lambda bwd=bwd: fa.flash_attention_dkv(*bwd, **kw)
    return calls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_wide: no CUDA device (use --device cpu for the plain versions)")
    result = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fn in cases(dev).items():
        row = {"ms": timed(fn, 3, dev, args.calls)}
        if dev.type == "cuda":
            row["kernels_ms"] = kernel_ms(fn, args.calls)
        result[name] = row
    return result


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
