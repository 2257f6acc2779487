"""Kernel K1: the codebook top-k sweep (replaces the Pallas kernel
``medtok_tpu/ops/vq_pallas.py::fused_topk_l2``).

``fused_topk_l2(z, codebook, k)`` returns (values [B, k] f32, indices [B, k]
i32) of the k smallest squared-L2 distances of each z row to the codebook
rows, ties to the lowest index. On CUDA tensors it launches
``csrc/topk_l2.cu``; on CPU tensors it runs the plain version
``fused_topk_l2_reference``. A region of the codebook is a row slice, which
reaches the kernel as a pointer offset plus a row count (no copy).

Widths: the kernel is built at 16, 32, 64, 128 and 256 (the export's
codebook: 64); any other width from 1 to 256 is zero-padded up to the next
of those (z and the codebook are copied then; zero columns add exact zeros
to every distance). k is 1 to 8: the kernel keeps its top-k in registers,
and no CLI sets ``QuantizerConfig.top_k`` (default 5).

Bound: 2*B*N*D fp32 operations over a 5.4 MB codebook at the export's
shape, so the fp32 CUDA-core rate bounds it (TF32 would break exact
indices); the kernel's source note says how its design meets that.
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


def _check(z: torch.Tensor, codebook: torch.Tensor, k: int) -> int:
    """Raise on anything K1 does not take; returns the width it runs at
    (the embedding width padded up to one the kernel is built at)."""
    for name, t in (("z", z), ("codebook", codebook)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    D, N = z.shape[1], codebook.shape[0]
    if codebook.shape[1] != D:
        raise ValueError(f"z {tuple(z.shape)} and codebook {tuple(codebook.shape)} "
                         "differ in width")
    width = _build.kernel_width(D, "embedding width")
    if not 1 <= k <= min(_MAX_K, N):
        raise ValueError(f"k={k} must be in [1, min({_MAX_K}, N={N})]: the kernel "
                         f"keeps at most {_MAX_K} in registers")
    return width


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
    width = _check(z, codebook, k)
    B, N = z.shape[0], codebook.shape[0]
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
    zp, ep = _build.pad_width(z, width), _build.pad_width(codebook, width)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.medtok_topk_l2(
            zp.data_ptr(), ep.data_ptr(), B, N, width, k, splits, per_split,
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), stream,
        )
    _build.check(code, "topk_l2")
    fused_topk_l2.launches += 1
    return vals, idx


#: launches of the CUDA kernel (CPU calls of the plain version do not count)
fused_topk_l2.launches = 0
