"""Batch structures as NamedTuples of tensors (counterpart of
``medtok_tpu/data/types.py``).

Shapes: B = batch, Lt = text bucket, Ln = nodes-per-graph bucket, E = edge
slots (flat across the batch). Graph i's edges occupy slots
[i*Epg, (i+1)*Epg) with Epg = E // B and hold within-graph node indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CodeBatch(NamedTuple):
    input_ids: torch.Tensor        # [B, Lt] int32 WordPiece ids, padded
    attention_mask: torch.Tensor   # [B, Lt] int32, 1 = real token
    node_ids: torch.Tensor         # [B, Ln] int32 global KG node indices
    node_mask: torch.Tensor        # [B, Ln] bool, True = real node
    edge_src: torch.Tensor         # [E] int32 within-graph node indices
    edge_dst: torch.Tensor         # [E] int32
    edge_weight: torch.Tensor      # [E] f32, 1.0 real / 0.0 padded
    edge_src_aug: torch.Tensor     # [E] edge-dropout-augmented copy
    edge_dst_aug: torch.Tensor     # [E]
    edge_weight_aug: torch.Tensor  # [E]
    code_indices: torch.Tensor     # [B] int32 row index into the code vocab

    def to(self, device: torch.device | str) -> "CodeBatch":
        """Move every field (numpy arrays included) to ``device``. Fields
        that alias one array (the eval batch's aug edges) move once."""
        moved: dict[int, torch.Tensor] = {}

        def one(x):
            key = id(x)
            if key not in moved:
                t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                moved[key] = t.to(device, non_blocking=True)
            return moved[key]

        return CodeBatch(*(one(x) for x in self))


class PackedTextBatch(NamedTuple):
    """A CodeBatch's texts packed into shared [R, P] encoder rows
    (``data/packing.py::pack_code_batch``)."""

    input_ids: torch.Tensor   # [R, P] int32
    seg_ids: torch.Tensor     # [R, P] int32 (0 = empty slot, else 1 + code slot)
    pos_ids: torch.Tensor     # [R, P] int32 within-segment positions
    gather_idx: torch.Tensor  # [B, Lmax] flat indices into the R*P slots
    text_mask: torch.Tensor   # [B, Lmax] bool

    def to(self, device: torch.device | str) -> "PackedTextBatch":
        """Move every field (numpy arrays included) to ``device``; the
        gather map becomes int64 for indexing."""
        def one(x):
            t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            return t.to(device, non_blocking=True)

        moved = [one(x) for x in self]
        moved[3] = moved[3].long()
        return PackedTextBatch(*moved)


class TokenizedCodes(NamedTuple):
    """Eval output per code."""

    embedding: torch.Tensor  # [B, 256] cat(spec_text, spec_graph, shared_text, shared_graph)
    tokens: torch.Tensor     # [B, 4, k] rows: text, graph, shared_text, shared_graph
    weights: torch.Tensor    # [B, 4, k]
