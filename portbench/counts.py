"""The yardstick's arithmetic: the card's peaks, the least time of kernels K1
(the codebook sweep) and K2 (packed segment attention) from the shapes they
were given, and the model operations that codes of given true sizes need.

Peaks are an NVIDIA H100 SXM's data-sheet dense rates at its 700 W limit. A
kernel's bound is the larger of its operations over the peak for their type
and its bytes over the memory rate, each input byte read once and each
output byte written once.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12      # HBM3 bytes/s
PEAK_TF32 = 495e12        # tensor-core TF32 FLOP/s
PEAK_BF16 = 989e12        # tensor-core bf16 FLOP/s


def k1_bound_s(rows: int, codewords: int, dim: int, k: int) -> float:
    """One K1 sweep of z [rows, dim] against [codewords, dim] fp32 rows,
    the k nearest out (int32 ids and fp32 distances): three TF32 products
    (the 3xTF32 split that keeps fp32 accuracy) at the TF32 peak, or the
    bytes."""
    ops = 3 * 2.0 * rows * codewords * dim
    nbytes = 4.0 * (rows * dim + codewords * dim) + 8.0 * rows * k
    return max(ops / PEAK_TF32, nbytes / PEAK_BYTES)


def k2_bound_s(seg: np.ndarray, heads: int, head_dim: int) -> float:
    """One bf16 K2 layer over packed rows with segment ids ``seg`` [R, P]
    (0 = empty): q, k and v read where a token is, the output and the ids
    written / read once; QK^T and PV over the (query, key) pairs of one
    segment at the bf16 peak."""
    seg = np.asarray(seg)
    R, P = seg.shape
    pairs = 0.0
    for row in seg:
        counts = np.bincount(row[row > 0])
        pairs += float((counts.astype(np.float64) ** 2).sum())
    tokens = float((seg > 0).sum())
    ops = 4.0 * heads * head_dim * pairs
    nbytes = 3.0 * heads * head_dim * 2 * tokens + R * heads * P * head_dim * 2 + R * P * 4
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def model_flops(model_cfg: dict, tokens, nodes, edges, *, train: bool) -> float:
    """Operations (a multiply-add is two) that codes of these true sizes
    need: no padding, no repeated rows. The frozen BERT runs forward only;
    text_mapped, the graph encoder (twice in training: the clean and the
    edge-dropped view), the cross-attention and the specific projections run
    forward, and in training backward at twice that; the codebook sweeps
    (4 in the export, 6 in training) run forward only."""
    t = np.asarray(tokens, np.float64)
    n = np.asarray(nodes, np.float64)
    e = np.asarray(edges, np.float64)
    tc, gc, qc = model_cfg["text"], model_cfg["graph"], model_cfg["quantizer"]
    E, I, L = tc["hidden_size"], tc["intermediate_size"], tc["num_layers"]
    bert = L * (2 * t * (4 * E * E + 2 * E * I) + 4 * t * t * E)
    D = qc["codebook_embed_dim"]
    text_mapped = 2 * t * E * gc["out_channels"]
    cin, hid, out = gc["in_channels"], gc["hidden_channels"], gc["out_channels"]
    agg = e + n                                  # edges and one self-loop a node
    if gc["model_name"] == "GCN":
        graph = 2 * n * (cin * hid + hid * out) + 2 * agg * (hid + out)
    else:
        H = gc["gat_num_heads"]
        graph = (2 * n * (cin * H * hid + H * hid * out)      # projections
                 + 4 * n * (H * hid + out)                    # attention logits
                 + 2 * agg * (H * hid + out))                 # weighted messages
    cross = qc["cross_attn_layers"] * (8 * t * D * D + 8 * n * D * D + 8 * t * n * D)
    C = qc["codebook_size"]
    region = C // 3
    if train:
        sweeps = 2 * D * (2 * C + 4 * region)
        trainable = text_mapped + 2 * graph + cross + 4 * 2 * D * D
        per_code = bert + 3 * trainable + sweeps
    else:
        sweeps = 2 * D * (2 * C + 2 * region)
        per_code = bert + text_mapped + graph + cross + 2 * 2 * D * D + sweeps
    return float(np.sum(per_code))
