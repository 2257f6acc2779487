"""Expansion of a CompactCodeBatch into the CodeBatch on the batch's device
(counterpart of ``medtok_tpu/data/compact.py::unpack_compact``).

Torch ops on whatever device the compact batch lies on (the card on the
export path). The STREAM encoding's sources are rebuilt by a batched
``torch.searchsorted`` over each graph's out-degree prefix sums, not by the
JAX package's broadcast compare, which an eager framework would
materialize (B x Epg x Ln compares). ``derive_packed_meta`` is in
``data/packing.py``.
"""

from __future__ import annotations

import torch

from medtok_tpu_torch.data.types import CodeBatch, CompactCodeBatch

__all__ = ["unpack_compact"]


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values of an int16 tensor that holds uint16 bytes."""
    return x.to(torch.int32) & 0xFFFF


def _expand(edge_packed: torch.Tensor, ne: torch.Tensor, batch: int,
            outdeg: torch.Tensor | None = None):
    """(src, dst, weight) [B * Epg] of one compact edge set."""
    epg = edge_packed.shape[0] // batch
    slot = torch.arange(epg, dtype=torch.int32, device=edge_packed.device)
    valid = slot[None, :] < ne.to(torch.int32)[:, None]        # edges front-packed
    if outdeg is not None:
        # STREAM: edges grouped by source node, so src_e = #{j : cum[j] <= e}
        # with cum the inclusive prefix sum of the out-degrees
        dst = _u16(edge_packed)
        od = _u16(outdeg).reshape(batch, -1)
        ln = od.shape[1]
        cum = torch.cumsum(od, dim=1, dtype=torch.int32)
        e = slot[None, :].expand(batch, epg).contiguous()
        src = torch.searchsorted(cum, e, right=True, out_int32=True)
        # padding slots fall past the last step: zero, as the classic layout
        src = torch.where(valid, src, 0).clamp_(max=ln - 1).reshape(-1)
    elif edge_packed.dtype == torch.int16:
        e = _u16(edge_packed)                                   # (src << 8) | dst
        src, dst = e >> 8, e & 0xFF
    else:
        # (src << 16) | dst with Ln <= 32768 keeps the sign bit clear
        src, dst = edge_packed >> 16, edge_packed & 0xFFFF
    return src, dst, valid.reshape(-1).to(torch.float32)


def unpack_compact(cb: CompactCodeBatch) -> CodeBatch:
    """The CodeBatch of ``cb``, on ``cb``'s device. Without aug fields (eval
    / export) the aug edges alias the clean ones."""
    B = cb.node_ids.shape[0]
    src, dst, w = _expand(cb.edge_packed, cb.ne, B, outdeg=cb.outdeg)
    if cb.edge_packed_aug is None:
        src_a, dst_a, w_a = src, dst, w
    else:
        src_a, dst_a, w_a = _expand(cb.edge_packed_aug, cb.ne_aug, B, outdeg=cb.outdeg_aug)
    ln = cb.node_ids.shape[1]
    node_mask = (torch.arange(ln, dtype=torch.int32, device=cb.nn.device)[None, :]
                 < cb.nn.to(torch.int32)[:, None])
    return CodeBatch(
        input_ids=cb.input_ids, attention_mask=cb.attention_mask,
        node_ids=cb.node_ids, node_mask=node_mask,
        edge_src=src, edge_dst=dst, edge_weight=w,
        edge_src_aug=src_a, edge_dst_aug=dst_a, edge_weight_aug=w_a,
        code_indices=cb.code_indices,
    )
