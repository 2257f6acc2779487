"""Kernel K1: the codebook top-k sweep (replaces the Pallas kernel
``medtok_tpu/ops/vq_pallas.py::fused_topk_l2``).

``fused_topk_l2(z, codebook, k)`` returns (values [B, k] f32, indices [B, k]
i32) of the k smallest squared-L2 distances of each z row to the codebook
rows, ties to the lowest index. On CUDA tensors it launches
``csrc/topk_l2.cu``; on CPU tensors it runs the plain version
``fused_topk_l2_reference``. A region of the codebook is a row slice, which
reaches the kernel as a pointer offset plus a row count (no copy).

Bound: 2*B*N*64 fp32 operations over a 5.4 MB codebook, so the fp32
CUDA-core rate bounds it (TF32 would break exact indices); the kernel's
source note says how its design meets that.
"""

from __future__ import annotations

import math

import torch

from medtok_tpu_torch.ops import _build
from medtok_tpu_torch.ops.vq import squared_distance, topk_smallest

# z rows per block of the kernel; the wrapper sizes the codebook splits so
# that each SM gets several blocks
_ROWS_PER_BLOCK = 64
_BLOCKS_PER_SM = 4
_MAX_K = 8


def fused_topk_l2_reference(
    z: torch.Tensor, codebook: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the fp32 distance matrix, then the k smallest
    by a stable (value, index) sort."""
    vals, idx = topk_smallest(squared_distance(z, codebook), k)
    return vals, idx.to(torch.int32)


def fused_topk_l2(
    z: torch.Tensor, codebook: torch.Tensor, *, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] f32, indices [B, k] i32) of the k nearest codebook rows.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return fused_topk_l2_reference(z, codebook, k)
    if z.device != codebook.device or z.device.type != "cuda":
        raise ValueError(
            f"z on {z.device} and codebook on {codebook.device}: both must "
            "be on one CUDA device (or both on the CPU)")
    for name, t in (("z", z), ("codebook", codebook)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    B, D = z.shape
    N = codebook.shape[0]
    if codebook.shape[1] != D or D != 64:
        raise ValueError(f"the kernel takes width 64, got z {tuple(z.shape)} "
                         f"and codebook {tuple(codebook.shape)}")
    if not 1 <= k <= min(_MAX_K, N):
        raise ValueError(f"k={k} must be in [1, min({_MAX_K}, N={N})]")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=z.device),
                torch.empty((0, k), dtype=torch.int32, device=z.device))

    lib = _build.load_library()
    tiles = math.ceil(N / lib.medtok_topk_tile_n())
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    row_blocks = math.ceil(B / _ROWS_PER_BLOCK)
    splits = max(1, min(tiles, math.ceil(_BLOCKS_PER_SM * sms / row_blocks)))
    per_split = math.ceil(tiles / splits)
    splits = math.ceil(tiles / per_split)

    dev = z.device
    part_v = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.medtok_topk_l2(
            z.data_ptr(), codebook.data_ptr(), B, N, D, k, splits, per_split,
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), stream,
        )
    _build.check(code, "topk_l2")
    fused_topk_l2.launches += 1
    return vals, idx


#: launches of the CUDA kernel (CPU calls of the plain version do not count)
fused_topk_l2.launches = 0
