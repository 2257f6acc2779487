"""A/B the dense-adjacency Count builds on the card (counterpart of
``scripts/bench_adj.py``).

At the Ln=512 node bucket a graph batch's normalized adjacency is built from
Count[b, i, j], the summed weight of edges j -> i
(``models/layers.py::gcn_norm_adj``). Variants, each normalized the same
way (``models/layers.py::gcn_normalize``):

  bf16_chunked  the production path, ``gcn_norm_adj`` (index_put_ Count)
  int8          int8 one-hots, int32 products by ``torch._int_mm`` per graph
                and edge chunk (exact for the pipeline's binary weights)
  cuda_count    kernel K5, ``ops/adj_count.py::adj_count`` (CUDA cores)
  cuda_onehot   kernel K5-lane, ``ops/adj_count.py::adj_count_onehot``
                (bf16 one-hot products on the tensor cores)

Every variant must agree with a numpy histogram of the same edges. The
edges are the JAX script's draw (``default_rng(3)``, 1/2 to all of each
graph's edge bucket used, the rest zero-weight padding). Times are CUDA
events, the least over trials after the first is dropped (host clock on the
CPU). If ``torch._int_mm`` refuses a shape, the ``int8`` row records
``{"error": ...}``; any other failure raises.

    python -m medtok_tpu_torch.scripts.bench_adj [--b 512] [--ln 512]
        [--epg 8192] [--variants bf16_chunked,int8,cuda_count,cuda_onehot]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.models.layers import gcn_norm_adj, gcn_normalize
from medtok_tpu_torch.ops.adj_count import adj_count, adj_count_onehot
from medtok_tpu_torch.scripts import timed

VARIANTS = ("bf16_chunked", "int8", "cuda_count", "cuda_onehot")
TRIALS = 3   # timed calls per variant, after a warm-up call


def draw_edges(B: int, Ln: int, Epg: int):
    """The JAX script's edges: (src, dst [B, Epg] int32, w [B, Epg] fp32,
    ne [B] used edges per graph); graph b uses its first ne[b] slots with
    weight 1 and pads the rest with zeros."""
    rng = np.random.default_rng(3)
    ne = rng.integers(Epg // 2, Epg, B)
    src = np.zeros((B, Epg), np.int32)
    dst = np.zeros((B, Epg), np.int32)
    w = np.zeros((B, Epg), np.float32)
    for b in range(B):
        src[b, : ne[b]] = rng.integers(0, Ln, ne[b])
        dst[b, : ne[b]] = rng.integers(0, Ln, ne[b])
        w[b, : ne[b]] = 1.0
    return src, dst, w, ne


def histogram(src, dst, ne, Ln: int) -> np.ndarray:
    """Count of the used edges by numpy: [B, Ln, Ln] fp32."""
    truth = np.zeros((src.shape[0], Ln, Ln), np.float32)
    for b in range(src.shape[0]):
        np.add.at(truth[b], (dst[b, : ne[b]], src[b, : ne[b]]), 1.0)
    return truth


def normalized(truth: np.ndarray) -> np.ndarray:
    """The JAX script's check_adj reference from a numpy Count."""
    deg = 1.0 + truth.sum(axis=2)
    dinv = 1.0 / np.sqrt(deg)
    ref = dinv[:, :, None] * dinv[:, None, :] * truth
    ref += np.eye(truth.shape[1], dtype=np.float32)[None] * (dinv * dinv)[:, :, None]
    return ref


def int8_count(src, dst, w, B: int, Ln: int) -> torch.Tensor:
    """Count by int8 one-hot products, int32 sums: ``torch._int_mm`` of
    [Ln, chunk] and [chunk, Ln] per graph, in edge chunks whose one-hots
    stay under 1 GiB per side. Edges with weight <= 0 are dropped (the
    pipeline's weights are 1 or 0)."""
    sg, dg, wg = src.view(B, -1), dst.view(B, -1), w.view(B, -1)
    Epg = sg.shape[1]
    chunk = max(min(Epg, (1 << 30) // max(B * Ln, 1)), 1)
    while Epg % chunk:
        chunk -= 1
    iota = torch.arange(Ln, dtype=src.dtype, device=src.device)
    count = torch.zeros((B, Ln, Ln), dtype=torch.int32, device=src.device)
    for c0 in range(0, Epg, chunk):
        d_ohT = ((dg[:, None, c0:c0 + chunk] == iota[None, :, None])
                 & (wg[:, None, c0:c0 + chunk] > 0)).to(torch.int8)   # [B, Ln, chunk]
        s_oh = (sg[:, c0:c0 + chunk, None] == iota).to(torch.int8)    # [B, chunk, Ln]
        for b in range(B):
            count[b] += torch._int_mm(d_ohT[b], s_oh[b])
    return count.float()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--ln", type=int, default=512)
    ap.add_argument("--epg", type=int, default=8192)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default=None, help="cpu runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, Ln, Epg = args.b, args.ln, args.epg
    wanted = args.variants.split(",")
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known: {VARIANTS}")

    src, dst, w, ne = draw_edges(B, Ln, Epg)
    ref = normalized(histogram(src, dst, ne, Ln))
    es, ed, ew = (torch.from_numpy(a.reshape(-1)).to(dev) for a in (src, dst, w))

    fns = {
        "bf16_chunked": lambda: gcn_norm_adj(es, ed, ew, B, Ln),
        "int8": lambda: gcn_normalize(int8_count(es, ed, ew, B, Ln)),
        "cuda_count": lambda: gcn_normalize(adj_count(es, ed, ew, B, Ln)),
        "cuda_onehot": lambda: gcn_normalize(adj_count_onehot(es, ed, ew, B, Ln)),
    }
    out = {"shape": f"B={B} Ln={Ln} Epg={Epg}",
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name in wanted:
        try:
            a = fns[name]()
        except RuntimeError as exc:
            if name != "int8":
                raise
            out[name] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
        else:
            err = float(np.abs(a.cpu().numpy() - ref).max())
            del a
            out[name] = {"ms": timed(fns[name], TRIALS, dev), "max_err": err}
        print(json.dumps({name: out[name]}), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
