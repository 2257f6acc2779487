"""Kernel K2: block-diagonal packed-segment attention (replaces the Pallas
kernel ``medtok_tpu/ops/flash_attention.py::packed_segment_attention``).

q, k, v are [B, H, L, Dh] and ``seg_ids`` [B, L] int32 (0 = padding). Query
i attends to key j iff seg_i == seg_j > 0; the softmax runs in fp32 and a
query row with no valid key returns 0. Forward only: the one caller is the
frozen text encoder.

On CUDA tensors ``packed_segment_attention`` launches
``csrc/segment_attention.cu``; on CPU tensors it runs the plain version.
Bound: at the packed BERT shape [256, 12, 128, 64] in bf16 the layer moves
4 x 50.3 MB (about 60 us at 3.35 TB/s) for at most 12.9 GFLOP, so it is
memory-bound; the kernel's source note gives its design.
"""

from __future__ import annotations

import math

import torch

from medtok_tpu_torch.ops import _build

_MASKED = -1e30  # finite stand-in for -inf, as in the TPU kernel


def packed_segment_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: the dense fp32 [B, H, L, L] masked softmax.
    Rows that are all padding return 0, as the kernel does (the dense BERT
    path would average them instead)."""
    Dh = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    seg = seg_ids.to(torch.int32)
    valid = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    s = torch.where(valid, s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)


def packed_segment_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Block-diagonal attention, [B, H, L, Dh] in and out.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    tensors = (q, k, v, seg_ids)
    if all(t.device.type == "cpu" for t in tensors):
        return packed_segment_attention_reference(q, k, v, seg_ids,
                                                  sm_scale=sm_scale)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("q, k, v and seg_ids must be on one CUDA device "
                         "(or all on the CPU)")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, L, Dh = q.shape
    if Dh != 64:
        raise ValueError(f"the kernel takes head width 64, got {Dh}")
    if seg_ids.shape != (B, L) or seg_ids.dtype != torch.int32:
        raise ValueError(f"seg_ids must be [B, L] = [{B}, {L}] int32, got "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_ids", seg_ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)

    lib = _build.load_library()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.medtok_segment_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
            out.data_ptr(), B, H, L, Dh, float(sm_scale),
            int(q.dtype == torch.bfloat16), stream,
        )
    _build.check(code, "segment_attention")
    packed_segment_attention.launches += 1
    return out


#: launches of the CUDA kernel (CPU calls of the plain version do not count)
packed_segment_attention.launches = 0
