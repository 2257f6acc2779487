"""Kernels K5 and K5-lane: the Count step of the dense normalized GCN
adjacency (replace the Pallas kernels ``pallas_count`` and ``pallas_lane``
of ``scripts/bench_adj.py``).

    Count[b, i, j] = sum_e bf16(w[b, e]) * 1[dst[b, e] = i] * 1[src[b, e] = j]

``edge_src`` / ``edge_dst`` are int32 [B*Epg] within-graph node indices in
[0, Ln), chunked per graph; ``edge_weight`` is fp32 [B*Epg] (padding edges
carry 0). The result is fp32 [B, Ln, Ln]. Each weight is rounded to bf16
first, as the JAX package's one-hot Count does
(``medtok_tpu/models/layers.py::gcn_norm_adj``).

Both launch two kernels of ``csrc/adj_count.cu``. The first, shared, is a
stable counting sort of each graph's kept edges by 128 x 128 Count tile
into scratch the wrapper allocates. The second gives each (graph, tile) one
block that reads only its tile's edges:

- ``adj_count`` (K5, CUDA cores) adds them into an fp32 tile in shared
  memory, one fp32 add per edge in edge order, then writes the tile once.
  Its Count is bit for bit the sequential edge-order fp32 sum of the bf16
  weights.
- ``adj_count_onehot`` (K5-lane) sorts its tile's edges by 16-row slab and
  multiplies each slab's bf16 one-hots, built in registers, with
  ``mma.sync`` into fp32: 2 * 16 * 128 FLOP an edge instead of
  2 * Ln * Ln.

Both are exact for binary weights and give identical bits on every launch
for any weights (no atomic decides a slot or a sum's order). On CPU
tensors both run the plain version ``adj_count_reference``, the
``index_put_(accumulate=True)`` Count that ``models/layers.py::gcn_norm_adj``
builds. An index outside [0, Ln) adds
nothing, in the kernels and the plain version alike. Bound: the function
moves the edges in and Count out and does one add per edge, so bytes bound
both kernels (the source note has the numbers at the Ln=512 tail shape).
"""

from __future__ import annotations

import torch

from medtok_tpu_torch.ops import _build


def adj_count_reference(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                        edge_weight: torch.Tensor, batch: int,
                        num_nodes: int) -> torch.Tensor:
    """Plain version: the bf16-rounded weights scattered into a zero
    [B, Ln, Ln] fp32 Count by ``index_put_(accumulate=True)``, which is
    deterministic on CUDA (a sorted reduction, one fp32 sum per cell). An
    edge with an index outside [0, Ln) matches no one-hot row in the JAX
    Count, so it adds nothing here: it is sent to cell (0, 0) with weight 0."""
    E = edge_src.shape[0]
    if E % batch:
        raise ValueError("edge array must be per-graph chunked")
    dev = edge_src.device
    b = torch.arange(batch, device=dev).repeat_interleave(E // batch)
    count = torch.zeros((batch, num_nodes, num_nodes), dtype=torch.float32, device=dev)
    inside = ((torch.minimum(edge_src, edge_dst) >= 0)
              & (torch.maximum(edge_src, edge_dst) < num_nodes))
    w = torch.where(inside, edge_weight.to(torch.bfloat16).float(), 0.0)
    return count.index_put_((b, edge_dst.where(inside, 0).long(),
                             edge_src.where(inside, 0).long()), w, accumulate=True)


def _count_launch(entry: str, edge_src, edge_dst, edge_weight, out,
                  batch: int, num_nodes: int, scratch=()) -> None:
    """Launch ``entry`` on the edges' device and current stream, with the
    scratch tensors' pointers after ``out``; raises on a refused launch."""
    lib = _build.load_library()
    dev = edge_src.device
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            edge_src.data_ptr(), edge_dst.data_ptr(), edge_weight.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in scratch), batch, num_nodes,
            edge_src.shape[0] // batch, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, entry)


def _count_out(edge_src, edge_dst, edge_weight, batch: int,
               num_nodes: int) -> torch.Tensor:
    """Raise on anything K5 / K5-lane does not take; returns the empty
    fp32 [B, Ln, Ln] Count for the kernel to fill."""
    dev = edge_src.device
    if dev.type != "cuda" or any(t.device != dev for t in (edge_dst, edge_weight)):
        raise ValueError("edge_src, edge_dst and edge_weight must be on one "
                         "CUDA device (or all on the CPU)")
    E = edge_src.shape[0]
    for name, t, dtype in (("edge_src", edge_src, torch.int32),
                           ("edge_dst", edge_dst, torch.int32),
                           ("edge_weight", edge_weight, torch.float32)):
        if t.dtype != dtype or t.shape != (E,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [E] {dtype} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if batch <= 0 or E == 0 or E % batch:
        raise ValueError(f"{E} edges are not chunked into {batch} graphs")
    if not 0 < num_nodes <= 32640:
        raise ValueError(f"num_nodes {num_nodes} must be in [1, 32640]")
    return torch.empty((batch, num_nodes, num_nodes), dtype=torch.float32, device=dev)


def _count(entry: str, edge_src, edge_dst, edge_weight, batch: int,
           num_nodes: int) -> tuple[torch.Tensor, bool]:
    """The Count by the plain version on CPU tensors, else by the kernel
    ``entry`` (raising on anything it does not take) with the scratch of the
    bucket pre-pass: each graph's kept edges bucketed by tile, and each
    tile's start. The flag says whether the kernel was launched."""
    if all(t.device.type == "cpu" for t in (edge_src, edge_dst, edge_weight)):
        return adj_count_reference(edge_src, edge_dst, edge_weight, batch, num_nodes), False
    out = _count_out(edge_src, edge_dst, edge_weight, batch, num_nodes)
    dev = edge_src.device
    tiles = _build.load_library().medtok_adj_lane_tiles(num_nodes)
    scratch = (torch.empty(edge_src.shape[0], dtype=torch.int32, device=dev),
               torch.empty(batch * (tiles + 1), dtype=torch.int32, device=dev))
    _count_launch(entry, edge_src, edge_dst, edge_weight, out, batch, num_nodes, scratch)
    return out, True


def adj_count(edge_src: torch.Tensor, edge_dst: torch.Tensor,
              edge_weight: torch.Tensor, batch: int, num_nodes: int) -> torch.Tensor:
    """Count (K5, edge-order fp32 adds of each tile's own edges on the CUDA
    cores), fp32 [B, Ln, Ln]. CPU tensors take the plain version; CUDA
    tensors launch the kernels or raise."""
    out, launched = _count("medtok_adj_count", edge_src, edge_dst, edge_weight,
                           batch, num_nodes)
    adj_count.launches += launched
    return out


def adj_count_onehot(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     edge_weight: torch.Tensor, batch: int,
                     num_nodes: int) -> torch.Tensor:
    """Count (K5-lane, bf16 one-hot products of each tile's own edges on the
    tensor cores), fp32 [B, Ln, Ln]. CPU tensors take the plain version;
    CUDA tensors launch the kernels or raise."""
    out, launched = _count("medtok_adj_count_onehot", edge_src, edge_dst,
                           edge_weight, batch, num_nodes)
    adj_count_onehot.launches += launched
    return out


#: launches of the CUDA kernels (CPU calls of the plain version do not count)
adj_count.launches = 0
adj_count_onehot.launches = 0
