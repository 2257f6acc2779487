#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (medtok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--codes 16384]

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit, torch and CUDA);
  2. build the CUDA kernels from medtok_tpu_torch/csrc/ with nvcc;
  3. hold kernel K1 (top-k codebook sweep, 3xTF32 on the tensor cores)
     against its plain version at the export shapes (4096 x 21000 and the
     7000-row region), at k = 1 and 8, at B = 1 and 4097 (a ragged row
     tile), on the graph region of a width-16 codebook and on rows scaled by
     30 (tolerances scaled by |z||e|), with a case of exact ties
     (duplicated codewords must give bit-identical distances);
  4. hold kernel K2 (packed segment attention) against its plain version at
     [256, 12, 128, 64] in fp32 and bf16 (bf16 against the fp32 plain
     version and, element by element, against the bf16 one that rounds the
     probabilities where the kernel does) on two real packings of the first
     export group, the whole group (the layout the export launches K2 on)
     and 80% of it (last rows empty), and at L = 100 and 200 on
     interleaved, single-token and padded segments; time it on both
     packings beside scaled_dot_product_attention and its bound;
  5. run the packed full-vocabulary export at the full ModelConfig() width
     (bert-base, 130K-node GCN, 21000 x 64 codebook, bf16) over a synthetic
     heavy-tail vocabulary, counting kernel launches, and hold a small fp32
     export with kernels against the plain versions on the CPU;
  6. answer tokenize / encode / embed requests for three codes;
  7. hold kernel K3 (flash attention forward, dq and dk/dv) against its
     plain version at the EHR shape [256*4, 2003, 16] on an EHR batch's key
     mask, dropout 0.5, with a batch row that has no valid key, the plain
     version run in slices of 8 batch rows with the whole batch's dropout
     bits: fp32 out / lse / dq / dk / dv through autograd; bf16 each kernel
     (all three on the tensor cores) against its plain version on the same
     inputs, element by element within one bf16 ulp of each term of its sum
     (out: and one of its value) and under 1% of the elements differing,
     two backward passes bitwise equal and equal to the autograd
     Function's; the same bf16 checks at Lq != Lk, lengths 100 and 700, key
     masks with holes and with dropout 0; time the kernels on the path's
     mask and on an all-valid one beside scaled_dot_product_attention and
     the per-score floors (exp, and the issue slots of K3_SLOTS);
  8. train the EHR outcome model at EHRTrainConfig() width (batch 256,
     2003 positions, 4 layers of 4 heads, 64 wide) on the export's
     embeddings_all for one epoch of a few steps and evaluate it on two
     batches, counting K3 launches, then time and profile a train step, and
     time one on an all-valid batch;
  9. hold the trained EHR model's eval logits on the card (K3 in fp32 under
     "highest", bf16 under "default") against the plain versions on the
     CPU on a small batch;
 10. hold kernel K4 (packed segment attention in the [B, L, H, Dh] layout)
     against its plain version and against K2 on the transposed inputs (bit
     for bit) at [256, 128, 12, 64] on phase 4's packings and edge cases,
     time it as K2, and beside K2 with and without the head transposes;
 11. hold kernels K5 and K5-lane (the dense-adjacency Count) against their
     plain version and a numpy histogram at B=512, Ln=512, Epg=8192 with
     the bench script's edges (bit for bit on binary weights; within 1e-6
     and identical across two launches on fractional ones, K5's bit for
     bit numpy's edge-order fp32 np.add.at), at an export
     shape (Ln=128, Epg=1024), at a dense shape (B=64, Ln=16, Epg=8192,
     about 24 edges per Count cell, where a sum in another order or
     precision would show) and on K5_EDGE_CASES (every edge in one
     128 x 128 tile at Epg=65536, indices outside [0, Ln), zero weights
     between used slots, Ln = 1, 200 and 1000); time both at the first
     shape beside index_put_, split each one's two launches (the shared
     bucket pre-pass, then K5's tile adds or K5-lane's products) by device
     time under torch.profiler and log K5-lane's one-hot product floor;
 12. run the slice-3 entry points at their full default shapes, counting
     kernel launches: the packed-BERT probe
     (medtok_tpu_torch.scripts.profile_bert, K2 and K4 12 per kernel-leg
     call) and the Count A/B (medtok_tpu_torch.scripts.bench_adj, every
     variant within 1e-6 of the histogram);
 13. the widths (run right after the build): the witnesses of ROADMAP
     Queue 3's fixed width faults (K3 on [1, 1, 1, 32] bf16 and K2 on [1, 1,
     1, 8] bf16 return v, K1 on z [1, 16] against 5 codewords gives the
     plain version's indices; width 264 runs: K3 and K2 on [1, 1, 1, 264]
     return v, K1 at D = 264 and at k = 9 gives the plain version's
     indices, each through its wide route), then each kernel against its
     plain version at other widths, in both dtypes where it has both
     routes, by the checks of phases 3, 4, 7 and 10: K3 fwd / dq / dkv at
     head widths 8, 12, 32, 64, 128, 256; K2 and K4 at 8, 16, 32, 128, 256;
     K1 at 16, 32, 100, 128, 256 (widths that are no built width run
     zero-padded); then the wide routes the same way: K3, K2 and K4 at
     257, 320, 512 and 1000, K1 at those D with k = 9, 16 and 64, k = 9-64
     at D = 64, and a case of exact ties at D = 320, k = 16; each wide
     route's launches counted and each timed beside its plain version, the
     library call and its bound;
 14. the model-level witnesses: EHRTrainer(EHRTrainConfig(num_heads=2))
     (head width 32) trains two steps on the card with 4 launches of each
     K3 kernel a step, and an fp32 export at the verify recipe's widths
     (text hidden 32 / 4 heads, codebook 90 x 16) on the card is held to
     the plain versions on the CPU by phase 5's tie-gap rule;
 15. train the tokenizer at ModelConfig() width through Trainer.fit with
     TrainConfig(packed_text=True, global_batch_size=1024) over
     epoch_batches of phase 5's dataset (edge dropout on): a warm-up step,
     5 timed steps over batches collated in advance (the step alone: ms/step,
     peak memory), 5 timed steps of fit drawing from epoch_batches (end to
     end: codes/s with the collate inside the clock), each with 6 K1 and 12
     K2 launches a step, the host batch build timed apart, one profiled step split by
     part (frozen BERT forward; text_mapped, GCN, cross-attention, the K1
     sweeps and their recomputes, losses: forward and backward;
     clip + Adam + EMA); fail on a non-finite loss, usage outside (0, 1], a
     changed BERT parameter, a trainable tensor that did not move, or two
     forward + backward passes from one state and generator state whose
     gradients are not bitwise equal; K1 on the six sweeps' inputs of the
     warm-up step and K2 on the training packing, each held to its plain
     version as in phases 3 and 4; then one fp32 train step at the
     verify recipe's widths on the card against the plain versions on the
     CPU (token rows by the tie-gap rule, loss terms within 1e-5, gradients
     within 1e-4 of the largest); then one checkpoint of the live state
     (EMA on), restored into a fresh Trainer: two more steps from each must
     be bitwise equal (parameters, usage FIFO, Adam state, EMA, generator),
     with the save and restore times and the file size logged;
 16. the CLIs at ModelConfig() width in fp32 on files a user would give
     them (a 130,000-node kg.csv of 1 M edges, a 4,096-code codes.jsonl,
     vocab.txt): medtok_tpu_torch.cli.train at batch 1024 to step 2 with a
     checkpoint every step, resumed with --workdir to step 4 (only
     0000003.pt and 0000004.pt left, finite losses), then
     medtok_tpu_torch.cli.export --workdir, each run with K1 and K2
     launched and its wall time logged, and MedTok.from_checkpoint on 256
     codes held to the export's rows by phase 5's tie-gap rule.
Phase 5's profile also reports the device time of the Count build
(gcn_norm_adj) in the export's tail node buckets, of K2, and of K1 per
shape (z rows x codebook rows) with its launches.
It then prints the card, one JSON line of kernel measurements and, last,
{"ok": true, "device": {...}}. Without CUDA, or without the repository
beside it, it exits non-zero and prints no result. fp32 matmuls and
convolutions run in full fp32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 CUDA-core FLOP/s, TF32
# and bf16 tensor-core FLOP/s. The bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the peak for their type.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
BF16_ULP = 2.0 ** -7    # bf16 keeps 8 significant bits

K = 5
D = 64
EHR_TRAIN_STEPS = 4     # train batches of one epoch
EHR_EVAL_BATCHES = 2
K3_SLICE = 8            # batch rows per slice of K3's plain version
K3_HEADS = 4
K3_SEED = 20261016
# issue slots of CUDA-core work per score in the bf16 kernels (the source
# note of csrc/flash_attention.cu): ex2 and its FFMA, the mask, the hash (one
# 3-input xor, three xorshifts, two multiplies, the compare), the keep select
# and scale, half a bf16 pair conversion; the forward adds the l sum and
# pass 0's scale and maximum, dq t - D and a * (t - D), dkv also scales a~
# and converts it
K3_SLOTS = {"fwd": 15.5, "dq": 17, "dkv": 19}
# head widths of the width phase (each kernel against its plain version);
# widths that are no built width are zero-padded by the wrappers
K3_WIDTHS = (8, 12, 32, 64, 128, 256)
SEGMENT_WIDTHS = (8, 16, 32, 128, 256)
K1_WIDTHS = (16, 32, 100, 128, 256)
# widths above the widest built one (the kernels' wide routes), and K1's k
# above the 3xTF32 kernel's 8
WIDE_WIDTHS = (257, 320, 512, 1000)
WIDE_K = (9, 16, 64)
# (B, Ln, Epg) of the Count checks: the bench's Ln=512 tail shape, an export
# bucket, and a dense shape whose cells sum many fractional weights
K5_SHAPES = ((512, 512, 8192), (512, 128, 1024), (64, 16, 8192))
# (label, B, Ln, Epg, k5_edges options) of the Count's edge cases: every
# edge in one 128 x 128 tile (more than a kernel's list takes at once),
# indices outside [0, Ln), zero weights inside the used slots, and node
# counts of one tile or none (Epg no multiple of the kernels' chunks)
K5_EDGE_CASES = (("one tile", 4, 512, 65536, {"hi": 128}),
                 ("out of range", 64, 512, 8192, {"out_of_range": True}),
                 ("zeros inside", 64, 512, 8192, {"zero_every": 3}),
                 ("Ln=1", 512, 1, 64, {}),
                 ("Ln=200", 64, 200, 3000, {}),
                 ("Ln=1000", 16, 1000, 20000, {}))
K5_SEED = 20261017
# L of the K2 / K4 edge-segment checks: no multiple of the kernels' tiles,
# one key block and two
SEGMENT_EDGE_LENGTHS = (100, 200)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    import torch

    from medtok_tpu_torch.scripts import timed

    return timed(fn, 1, torch.device("cuda"), iters)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- K1 --

def unit_rows(gen, dev, *shape):
    """Random rows of unit length, as the quantizer's normalized inputs."""
    import torch

    from medtok_tpu_torch.ops import vq

    return vq.l2_normalize(torch.randn(*shape, generator=gen, device=dev))


def check_k1_case(z, e, label: str, k: int = K, scale=1.0) -> float:
    """K1 on z against the codebook rows e, held to the plain version: rows
    without a near tie (gaps > 1e-5) identical, rows whose k-th gap exceeds
    1e-5 set-equal, values within 1e-5. On rows longer than unit length the
    gap and value tolerances scale by |z| |e| (``scale``, one per row or one
    for all): the rounding of the products and norms grows with them.
    Returns the largest value error."""
    import torch

    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    B = z.shape[0]
    vals, idx = fused_topk_l2(z, e, k=k)
    torch.cuda.synchronize()
    tol = 1e-5 * torch.as_tensor(scale, dtype=torch.float32, device=z.device).reshape(-1, 1)
    tol_note = "" if isinstance(scale, float) and scale == 1.0 else \
        f" (tolerances 1e-5 x |z||e|, up to {float(tol.max()):.3e}, on rows scaled up)"
    pv, pi = vq.topk_smallest(vq.squared_distance(z, e), k + 1)
    gaps = pv[:, 1:] - pv[:, :-1]                  # [B, k]
    clean = (gaps > tol).all(dim=1)                # no near tie anywhere
    boundary_ok = gaps[:, k - 1] > tol[:, 0]       # no tie at the k-th
    check(torch.equal(idx[clean].long(), pi[clean, :k]),
          f"K1 {label}: indices differ from the plain version on clean rows{tol_note}")
    same_set = (torch.sort(idx.long(), dim=1).values
                == torch.sort(pi[:, :k], dim=1).values).all(dim=1)
    check(bool(same_set[boundary_ok].all()),
          f"K1 {label}: index sets differ where the k-th gap exceeds the tolerance{tol_note}")
    ordered = (idx.long() == pi[:, :k]).all(dim=1)
    excess = float(((vals - pv[:, :k]).abs() - tol).max())
    err = float((vals - pv[:, :k]).abs().max())
    check(excess <= 0, f"K1 {label}: value error {err} beyond the tolerance{tol_note}")
    log(f"K1 {label} B={B} N={e.shape[0]} D={e.shape[1]} k={k}: {int(clean.sum())}/{B} "
        f"rows without near ties identical, {int(boundary_ok.sum())} rows with "
        f"the boundary gap over the tolerance set-equal ({int(ordered[boundary_ok].sum())} "
        f"of them in the same order), {int(ordered.sum())}/{B} rows identical "
        f"overall, max |value err| {err:.3e}{tol_note}")
    return err


def check_k1_ties(z, base, k: int, label: str) -> None:
    """Exact ties: K1 on z against every codeword of ``base`` twice. Each
    pair must rank the lower copy first with bit-identical distances, and
    the pairs' winners must be the plain version's on rows without a near
    tie (gaps > 1e-5)."""
    import torch

    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    N0, m = base.shape[0], (k + 1) // 2
    vals, idx = fused_topk_l2(z, torch.cat([base, base]), k=k)
    idx = idx.long()
    pairs = k // 2
    check(bool((idx[:, 1:2 * pairs:2] == idx[:, 0:2 * pairs:2] + N0).all()
               and (idx[:, 0::2] < N0).all()),
          f"{label}: duplicated rows not ranked lowest index first")
    check(bool((vals[:, 0:2 * pairs:2] == vals[:, 1:2 * pairs:2]).all()),
          f"{label}: duplicated rows gave different distances")
    pv, pi = vq.topk_smallest(vq.squared_distance(z, base), m + 1)
    clean = ((pv[:, 1:] - pv[:, :-1]) > 1e-5).all(dim=1)
    check(torch.equal(idx[clean][:, 0::2], pi[clean, :m]),
          f"{label}: winners differ from the plain version")
    log(f"{label}: {z.shape[0]} rows at D={z.shape[1]}, k={k} lowest-index-first over "
        f"{2 * N0} duplicated rows, bit-identical distances for each pair")


def check_k1(gen, dev) -> dict:
    import torch

    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2, fused_topk_l2_reference

    B, N = 4096, 21000
    z, cb = unit_rows(gen, dev, B, D), unit_rows(gen, dev, N, D)
    result = {label: dict(err=check_k1_case(z, e, label), n=e.shape[0])
              for label, e in (("full", cb), ("region", vq.region_slice(cb, "graph")))}
    # k at both ends; one row and a ragged last row tile; a region at the
    # graph offset of a width-16 codebook; rows 30x longer than unit
    for k in (1, 8):
        check_k1_case(z, cb, "full", k=k)
    for rows in (1, B + 1):
        check_k1_case(unit_rows(gen, dev, rows, D), cb, "rows")
    z16, cb16 = unit_rows(gen, dev, B, 16), unit_rows(gen, dev, N, 16)
    check_k1_case(z16, vq.region_slice(cb16, "graph"), "D=16 graph region")
    z30, cb30 = 30.0 * z, 30.0 * cb
    check_k1_case(z30, cb30, "rows scaled by 30",
                  scale=z30.norm(dim=1) * float(cb30.norm(dim=1).max()))

    check_k1_ties(z, unit_rows(gen, dev, N // 2, D), K, "K1 ties")

    # times at the full sweep (two of the four sweeps of a quantizer step)
    kernel_ms = cuda_ms(lambda: fused_topk_l2(z, cb, k=K), 50)
    plain_ms = cuda_ms(lambda: fused_topk_l2_reference(z, cb, K), 5)

    def library():
        d = (z * z).sum(1, keepdim=True) + (cb * cb).sum(1)[None] - 2.0 * (z @ cb.T)
        return torch.topk(d, K, dim=1, largest=False)

    library_ms = cuda_ms(library, 20)
    region_ms = cuda_ms(lambda: fused_topk_l2(z, vq.region_slice(cb, "text"), k=K), 50)
    ops = 2.0 * B * N * D
    nbytes = 4.0 * (B * D + N * D) + 8.0 * B * K
    # the kernel's work is three TF32 products per fp32 one (3xTF32)
    tf32_ms, fp32_ms = 3 * ops / PEAK_TF32 * 1e3, ops / PEAK_FP32 * 1e3
    bound_ms = max(tf32_ms, nbytes / PEAK_BYTES * 1e3)
    log(f"K1 B={B} N={N}: kernel {kernel_ms:.4f} ms (the CUDA-core fp32 sweep it "
        f"replaced: 0.6742 ms on NVIDIA H100 80GB HBM3 at 700 W), plain {plain_ms:.4f} ms, "
        f"library matmul+topk {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({ops / 1e9:.2f} GFLOP as 3xTF32 on the tensor cores; {fp32_ms:.4f} ms as "
        f"fp32 on the CUDA cores); region N={N // 3}: kernel {region_ms:.4f} ms")
    return dict(name="topk_l2", route="cuda",
                source="medtok_tpu_torch/csrc/topk_l2.cu",
                replaces="medtok_tpu/ops/vq_pallas.py:139",
                max_abs_err=result["full"]["err"], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if tf32_ms > nbytes / PEAK_BYTES * 1e3 else "bytes",
                library_ms=library_ms)


# --------------------------------------------------------------- K2 / K4 --

def packed_segments(dataset, dev, share: float):
    """[R, P] int32 segment ids of a greedy packing of the first `share` of
    the first export group: at 1.0 the layout the export's first BERT step
    launches K2 on; at 0.8 the last rows stay empty."""
    import numpy as np
    import torch

    from medtok_tpu_torch.export import export_groups, packed_layout

    row_len, num_rows, _ = packed_layout(dataset)
    group = export_groups(dataset)[0]
    _, base, lens = dataset.pack_text_rows(group[: int(share * len(group))],
                                           row_len=row_len, num_rows=num_rows)
    seg_np = np.zeros(num_rows * row_len, np.int32)
    for c, (b, n) in enumerate(zip(base.tolist(), lens.tolist())):
        seg_np[b:b + n] = c + 1
    return torch.from_numpy(seg_np.reshape(num_rows, row_len)).to(dev)


def segment_bound(seg, H: int, Dh: int) -> tuple[float, float, float]:
    """(bound ms, in-segment FLOP, bytes) of one bf16 K2 / K4 layer: q, k
    and v read once at the positions that hold a token (a padding query
    returns 0 and a padding key meets no query, so neither needs its
    inputs), the output and the segment ids once, and QK^T and PV over the
    (query, key) pairs of one segment."""
    R, P = seg.shape
    pairs = float(((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)).sum())
    ops = 4.0 * H * Dh * pairs
    nbytes = 3.0 * H * Dh * 2 * float((seg > 0).sum()) + R * H * P * Dh * 2 + R * P * 4
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3, ops, nbytes


def check_bf16_agreement(name: str, out, q, k, v, seg, plain) -> dict:
    """Hold a bf16 K2 / K4 output to the plain version on the same bf16
    inputs; both walk blocks of 128 keys and round the probabilities to
    bf16 before P.V against the running maximum. An element may differ by
    one bf16 ulp of the plain value plus one ulp of each P.V term,
    2^-7 * (|want| + sum_j p_j |v_j| / l) + 1e-6: the two sides sum the fp32
    scores in another order, so a probability's rounding can flip. Under 1%
    of the elements may differ at all (29.6% did before the kernels and
    plain versions rounded p). Returns the share that differs and how many
    differ by more than one ulp of the plain value alone."""
    tally = Bf16Tally()
    tally.add(out, plain(q, k, v, seg), plain(q.float(), k.float(), v.float().abs(), seg))
    return tally.check(name)


class Bf16Tally:
    """Counts, over one or more slices, the bf16 elements that differ from
    the plain version's, that differ by more than one bf16 ulp of the value,
    and that break the rule: within one ulp of the value plus one of each
    term of its sum, 2^-7 (|want| + terms) + 1e-6; with value_ulp False
    (the K3 gradients, whose terms sum to many times the value) within
    2^-7 terms + 1e-6."""

    def __init__(self, value_ulp: bool = True):
        self.value_ulp = value_ulp
        self.n = self.differ = self.beyond_ulp = self.beyond_tol = 0
        self.max_abs = 0.0

    def add(self, got, want, terms) -> None:
        want = want.float()
        diff = (got.float() - want).abs()
        self.n += diff.numel()
        self.differ += int((diff > 0).sum())
        self.beyond_ulp += int((diff > BF16_ULP * want.abs() + 1e-6).sum())
        value = want.abs() if self.value_ulp else 0.0
        self.beyond_tol += int((diff > BF16_ULP * (value + terms) + 1e-6).sum())
        self.max_abs = max(self.max_abs, float(diff.max()) if diff.numel() else 0.0)

    def check(self, name: str) -> dict:
        """Fails on any element beyond the rule or on 1% or more differing;
        returns the share that differs and the count beyond one ulp."""
        check(self.beyond_tol == 0,
              f"{name}: {self.beyond_tol} elements beyond one bf16 ulp of their terms")
        share = self.differ / max(self.n, 1)
        check(share < 0.01, f"{name}: {100 * share:.3f}% of the elements differ from the "
              f"bf16 plain version")
        return dict(share=share, beyond_ulp=self.beyond_ulp, max_abs=self.max_abs)


def edge_segments(dev, L: int):
    """[5, L] int32 segment ids that a packing never makes, for the tile
    skip and the tails: five segments interleaved (seg = i % 5 + 1),
    single-token segments, runs of 9 ending in 7 positions of padding, a
    row of padding, and interleaved segments broken by padding."""
    import torch

    i = torch.arange(L)
    zero = torch.zeros_like(i)
    rows = (i % 5 + 1, i + 1, torch.where(i < L - 7, i // 9 + 1, zero), zero,
            torch.where(i % 3 == 0, zero, i % 7 + 1))
    return torch.stack(rows).to(device=dev, dtype=torch.int32)


def segment_fns(nt: bool):
    """(name, wrapper, plain version) of K4 (nt) or K2."""
    from medtok_tpu_torch.ops import flash_attention as fa

    if nt:
        return "K4", fa.packed_segment_attention_nt, fa.packed_segment_attention_nt_reference
    return "K2", fa.packed_segment_attention, fa.packed_segment_attention_reference


def heads_first(*ts):
    """[B, L, H, Dh] tensors copied to [B, H, L, Dh]."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def check_segment_case(gen, dev, seg, nt: bool, label: str, H: int = 12,
                       Dh: int = D) -> dict:
    """K2 (nt False, [B, H, L, Dh]) or K4 (nt True, [B, L, H, Dh]) on one
    segment layout, from the same random inputs in fp32 and rounded to
    bf16: fp32 within 1e-5 and bf16 within 2e-2 of the fp32 plain version,
    bf16 held to the bf16 plain version by check_bf16_agreement, padding
    rows 0; K4 also bit for bit equal to K2 on the transposed inputs. Logs
    a line; returns the bf16 inputs and the largest errors."""
    import torch

    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention

    kernel, fn, plain = segment_fns(nt)
    name = f"{kernel} {label}"
    B, L = seg.shape
    pad = seg == 0
    shape = (B, L, H, Dh) if nt else (B, H, L, Dh)
    q32, k32, v32 = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        out = fn(q, k, v, seg)
        tag = str(dtype).split(".")[-1]
        errs[tag] = float((out.float() - plain(q.float(), k.float(), v.float(), seg))
                          .abs().max())
        check(out.dtype == dtype and out.shape == q.shape,
              f"{name} {tag}: output {out.dtype} {tuple(out.shape)}")
        check(errs[tag] <= tol, f"{name} {tag}: max error {errs[tag]} > {tol}")
        check(bool(((out if nt else out.transpose(1, 2))[pad] == 0).all()),
              f"{name} {tag}: padding rows not 0")
        if nt:
            k2 = packed_segment_attention(*heads_first(q, k, v), seg).transpose(1, 2)
            check(torch.equal(out, k2), f"{name} {tag}: K4 differs from K2 on the "
                  f"transposed inputs")
    agree = check_bf16_agreement(f"{name} bf16", out, q, k, v, seg, plain)
    log(f"{name} {list(shape)}: fp32 max err {errs['float32']:.3e}, bf16 max err "
        f"{errs['bfloat16']:.3e} vs fp32 plain; bf16 vs bf16 plain: "
        f"{100 * agree['share']:.4f}% differ, {agree['beyond_ulp']} beyond one ulp of the "
        f"value, 0 beyond the tolerance; padding rows 0 ({int(pad.all(dim=1).sum())} "
        f"all-padding rows)" + ("; bit for bit equal to K2 on the transposed inputs"
                                if nt else ""))
    return dict(q=q, k=k, v=v, err16=errs["bfloat16"])


def segment_times(nt: bool, q, k, v, seg) -> dict:
    """ms of K2 (nt False) or K4 on bf16 inputs in its layout, of its plain
    version and of scaled_dot_product_attention with the boolean pair mask
    on the [B, H, L, Dh] views, and this layout's bound."""
    import torch.nn.functional as F

    _, fn, plain = segment_fns(nt)

    def heads(t):
        return t.transpose(1, 2) if nt else t

    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    bound_ms, ops, nbytes = segment_bound(seg, q.shape[2 if nt else 1], q.shape[3])
    return dict(ms=cuda_ms(lambda: fn(q, k, v, seg), 20),
                plain_ms=cuda_ms(lambda: plain(q, k, v, seg), 5),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), attn_mask=mask), 20),
                bound_ms=bound_ms, ops=ops, nbytes=nbytes,
                bound_by="operations" if ops / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes")


def check_segment_kernel(gen, dev, nt: bool, layouts: dict) -> dict:
    """K2 (phase 4) or K4 (phase 10): checked by check_segment_case on each
    packing of `layouts` (label -> [R, P] seg ids, the export's first) and
    on edge_segments at each SEGMENT_EDGE_LENGTHS, then timed on each
    packing; K4 also beside K2 with and without the head transposes. The
    kernels line gets the times on the export's packing."""
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention

    kernel = segment_fns(nt)[0]
    cases = {label: check_segment_case(gen, dev, seg, nt, label)
             for label, seg in layouts.items()}
    err16 = max(c["err16"] for c in cases.values())
    for L in SEGMENT_EDGE_LENGTHS:
        edge = check_segment_case(gen, dev, edge_segments(dev, L), nt, f"edge segments L={L}")
        err16 = max(err16, edge["err16"])
    times = {}
    library = "sdpa+mask on the transposed views" if nt else "sdpa+mask"
    for label, seg in layouts.items():
        c = cases[label]
        t = times[label] = segment_times(nt, c["q"], c["k"], c["v"], seg)
        R, P = seg.shape
        log(f"{kernel} bf16 on the {label} ({int((seg > 0).sum())} of {R * P} positions hold "
            f"a token, {int((seg == 0).all(dim=1).sum())} empty rows): kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {library} "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['nbytes'] / 1e6:.1f} "
            f"MB, {t['ops'] / 1e9:.3f} GFLOP in-segment); kernel {t['ms'] / t['bound_ms']:.2f}x "
            f"the bound, library {t['library_ms'] / t['ms']:.2f}x the kernel")
    label = next(iter(layouts))
    if nt:
        c, seg = cases[label], layouts[label]
        qt, kt, vt = heads_first(c["q"], c["k"], c["v"])
        k2_ms = cuda_ms(lambda: packed_segment_attention(qt, kt, vt, seg), 20)
        k2_transposed_ms = cuda_ms(lambda: packed_segment_attention(
            *heads_first(c["q"], c["k"], c["v"]), seg).transpose(1, 2).contiguous(), 20)
        log(f"K4 bf16 on the {label}: K2 on [B, H, L, Dh] {k2_ms:.4f} ms, K2 with the three "
            f"input and one output transposes {k2_transposed_ms:.4f} ms")
    site = 654 if nt else 740
    return dict(name="segment_attention_nt" if nt else "segment_attention", route="cuda",
                source="medtok_tpu_torch/csrc/segment_attention.cu",
                replaces=f"medtok_tpu/ops/flash_attention.py:{site}", max_abs_err=err16,
                **{key: times[label][key] for key in ("ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")})


# --------------------------------------------------------------------- K5 --

def k5_edges(rng, B: int, Ln: int, Epg: int, hi: int | None = None, zero_every: int = 0,
             out_of_range: bool = False):
    """Edges for the Count's edge cases: indices uniform in [0, hi or Ln),
    weight 1 on the first 3/4 of each graph's slots and 0 after; zero
    weights also every zero_every-th slot; out_of_range moves a sixth of
    the indices outside [0, Ln). Flat src, dst int32 and w fp32."""
    import numpy as np

    hi = Ln if hi is None else hi
    src = rng.integers(0, hi, (B, Epg)).astype(np.int32)
    dst = rng.integers(0, hi, (B, Epg)).astype(np.int32)
    w = np.ones((B, Epg), np.float32)
    w[:, 3 * Epg // 4:] = 0.0
    if zero_every:
        w[:, ::zero_every] = 0.0
    if out_of_range:
        far = np.array([-1, Ln, -(2 ** 31), 2 ** 31 - 1, 2 * Ln], np.int64)
        for a in (src, dst):
            bad = rng.random((B, Epg)) < 1 / 6
            a[bad] = rng.choice(far, int(bad.sum())).astype(np.int32)
    return src.reshape(-1), dst.reshape(-1), w.reshape(-1)


def k5_edge_order(es, ed, w, B: int, Ln: int):
    """numpy Count summed in edge order in fp32: np.add.at of the bf16
    weights of the kept edges (bf16 weight != 0, both ends in [0, Ln)) on a
    zero float32 array, the sums K5 takes; on binary weights, the
    histogram. [B, Ln, Ln] fp32 on the edges' device."""
    import numpy as np
    import torch

    src, dst = es.cpu().numpy().astype(np.int64), ed.cpu().numpy().astype(np.int64)
    w16 = w.to(torch.bfloat16).float().cpu().numpy()
    b = np.repeat(np.arange(B, dtype=np.int64), src.shape[0] // B)
    ok = (w16 != 0) & (src >= 0) & (src < Ln) & (dst >= 0) & (dst < Ln)
    count = np.zeros(B * Ln * Ln, np.float32)
    np.add.at(count, (b[ok] * Ln + dst[ok]) * Ln + src[ok], w16[ok])
    return torch.from_numpy(count.reshape(B, Ln, Ln)).to(es.device)


def check_k5_case(gen, dev, label: str, es, ed, ew, truth, B: int, Ln: int) -> dict:
    """K5 and K5-lane on one set of edges: the binary Count bit for bit
    equal to the plain version and the histogram; fractional weights
    within 1e-6 of the largest count, two launches identical, and K5's bit
    for bit the edge-order fp32 sum of numpy's np.add.at. Returns the
    fractional max abs error by kernel name."""
    import torch

    from medtok_tpu_torch.ops.adj_count import (
        adj_count,
        adj_count_onehot,
        adj_count_reference,
    )

    plain = adj_count_reference(es, ed, ew, B, Ln)
    check(torch.equal(plain, truth), f"K5 plain version != histogram ({label})")
    wf = ew * torch.rand(ew.shape, generator=gen, device=dev)   # fractional
    plain_f = adj_count_reference(es, ed, wf, B, Ln)
    scale = float(plain_f.abs().max())
    errs = {}
    for fn in (adj_count, adj_count_onehot):
        name = fn.__name__
        got = fn(es, ed, ew, B, Ln)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{name} {label}: binary Count differs from the histogram")
        first, second = fn(es, ed, wf, B, Ln), fn(es, ed, wf, B, Ln)
        err = float((first - plain_f).abs().max())
        check(err <= 1e-6 * scale, f"{name} {label}: fractional error {err} > 1e-6 "
              f"of the largest count {scale}")
        check(torch.equal(first, second), f"{name} {label}: two launches differ")
        order = ""
        if fn is adj_count:
            check(torch.equal(first, k5_edge_order(es, ed, wf, B, Ln)),
                  f"{name} {label}: fractional Count is not the edge-order fp32 sum bit for bit")
            order = ", bit for bit numpy's edge-order fp32 np.add.at"
        errs[name] = err
        log(f"K5 {name} {label}: binary Count equal to the plain version and the histogram "
            f"bit for bit (largest count {float(truth.max()):.0f}); fractional max abs err "
            f"{err:.3e} (largest count {scale:.3f}){order}, two launches identical")
        del got, first, second
    return errs


def lane_products(es, ed, ew, B: int, Ln: int) -> tuple[float, int]:
    """K5-lane's one-hot products on these edges: each kept edge (bf16
    weight != 0, both ends inside Count) is multiplied in its 16-row slab
    of its 128 x 128 tile, 2 * 16 * 128 FLOP, each slab's run padded to 16
    edges (exact while no tile keeps more than the kernel's LIST_CAP, 4096
    edges, so that its list is sorted once). Returns (FLOP, padded edges)."""
    import torch

    ti = tj = 128
    tiles_j = -(-Ln // tj)
    tiles = -(-Ln // ti) * tiles_j
    b = torch.arange(B, device=es.device).repeat_interleave(es.shape[0] // B)
    keep = ((ew.to(torch.bfloat16) != 0) & (es >= 0) & (es < Ln) & (ed >= 0) & (ed < Ln))
    s, d, b = es[keep].long(), ed[keep].long(), b[keep]
    key = ((b * tiles + (d // ti) * tiles_j + s // tj) * (ti // 16)) + (d % ti) // 16
    cnt = torch.bincount(key, minlength=B * tiles * (ti // 16))
    padded = int(((cnt + 15) // 16 * 16).sum())
    return 2.0 * 16 * tj * padded, padded


def check_k5(gen, dev) -> list[dict]:
    """K5 and K5-lane against their plain version and the numpy histogram
    at the bench's tail shape, an export shape, a dense shape and the edge
    cases of K5_EDGE_CASES; times at the first."""
    import numpy as np
    import torch

    from medtok_tpu_torch.scripts.bench_adj import draw_edges

    frac_err = {}
    cases = [(f"B={B} Ln={Ln} Epg={Epg}", B, Ln, Epg, None) for B, Ln, Epg in K5_SHAPES]
    cases += [(label, B, Ln, Epg, opts) for label, B, Ln, Epg, opts in K5_EDGE_CASES]
    rng = np.random.default_rng(K5_SEED)
    for label, B, Ln, Epg, opts in cases:
        if opts is None:   # the bench script's draw
            src, dst, w, _ = draw_edges(B, Ln, Epg)
        else:
            src, dst, w = k5_edges(rng, B, Ln, Epg, **opts)
            label = f"{label} (B={B} Ln={Ln} Epg={Epg})"
        es, ed, ew = (torch.from_numpy(a.reshape(-1)).to(dev) for a in (src, dst, w))
        truth = k5_edge_order(es, ed, ew, B, Ln)   # binary weights: the histogram
        for name, err in check_k5_case(gen, dev, label, es, ed, ew, truth, B, Ln).items():
            frac_err[name] = max(frac_err.get(name, 0.0), err)
        if (B, Ln, Epg) == K5_SHAPES[0] and opts is None:
            times = k5_times(es, ed, ew, B, Ln, Epg)
            nnz = int((ew != 0).sum())
            flops, padded = lane_products(es, ed, ew, B, Ln)
        del truth, es, ed, ew

    B, Ln, Epg = K5_SHAPES[0]
    # The function reads the edges, writes Count and adds once per edge of
    # weight != 0: the bound of both kernels. K5-lane's one-hot products are
    # a floor of its design only.
    nbytes = 12.0 * B * Epg + 4.0 * B * Ln * Ln
    bound_ms = max(nnz / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if nnz / PEAK_FP32 > nbytes / PEAK_BYTES else "bytes"
    rows = []
    for name, site in (("adj_count", 154), ("adj_count_onehot", 205)):
        log(f"K5 {name} B={B} Ln={Ln} Epg={Epg}: kernel {times[name]:.4f} ms, plain "
            f"{times['plain']:.4f} ms, library index_put_ {times['index_put']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {nnz} edges of "
            f"weight != 0)")
        rows.append(dict(name=name, route="cuda", source="medtok_tpu_torch/csrc/adj_count.cu",
                         replaces=f"scripts/bench_adj.py:{site}",
                         max_abs_err=frac_err[name], ms=times[name], plain_ms=times["plain"],
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=times["index_put"]))
    log(f"K5 adj_count_onehot: one-hot method's yardstick, the chunked bf16 one-hot bmm "
        f"(every edge against every node) {times['onehot_bmm']:.4f} ms")
    for (name, launch), ms in times["split"].items():
        log(f"K5 {name} launch {launch}: {ms:.4f} ms of device time per call under "
            f"torch.profiler")
    log(f"K5 adj_count_onehot product floor: {padded} padded kept edges x 2 x 16 x 128 = "
        f"{flops / 1e9:.2f} GFLOP of one-hot products at the bf16 peak, "
        f"{flops / PEAK_BF16 * 1e3:.4f} ms (not a bound of the function; every edge in "
        f"every tile would be {2.0 * Ln * Ln * nnz / 1e9:.1f} GFLOP)")
    return rows


def k5_times(es, ed, ew, B: int, Ln: int, Epg: int) -> dict:
    """ms of both kernels, the plain version, one index_put_ Count and the
    chunked bf16 one-hot bmm (one-hots under 1 GiB a side), and under
    "split" each kernel's two launches by their device time under
    torch.profiler, keyed (kernel, launch); the two library calls must give
    the plain version's Count."""
    import torch

    from medtok_tpu_torch.ops.adj_count import (
        adj_count,
        adj_count_onehot,
        adj_count_reference,
    )

    dev = es.device
    plain = adj_count_reference(es, ed, ew, B, Ln)
    b = torch.arange(B, device=dev).repeat_interleave(Epg)
    idx = (b, ed.long(), es.long())
    w16 = ew.to(torch.bfloat16)
    chunk = min(Epg, (1 << 30) // (2 * B * Ln))
    iota = torch.arange(Ln, device=dev, dtype=es.dtype)
    sg, dg, wg = es.view(B, Epg), ed.view(B, Epg), w16.view(B, Epg)

    def index_put():
        return torch.zeros((B, Ln, Ln), device=dev).index_put_(idx, w16.float(),
                                                               accumulate=True)

    def onehot_bmm():
        count = torch.zeros((B, Ln, Ln), device=dev)
        for c0 in range(0, Epg, chunk):
            d = ((dg[:, None, c0:c0 + chunk] == iota[None, :, None]).to(torch.bfloat16)
                 * wg[:, None, c0:c0 + chunk])                     # [B, Ln, chunk]
            s = (sg[:, c0:c0 + chunk, None] == iota).to(torch.bfloat16)
            count += torch.bmm(d, s, out_dtype=torch.float32)
        return count

    for lib in (index_put, onehot_bmm):
        check(torch.equal(lib(), plain), f"library {lib.__name__} != the plain Count")
    # each kernel's two launches, by their device time under the profiler
    from torch.profiler import ProfilerActivity, profile

    calls = 10
    split = {}
    for fn, second in ((adj_count, "adj_count_tile_kernel"),
                       (adj_count_onehot, "adj_count_onehot_kernel")):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(es, ed, ew, B, Ln)
            torch.cuda.synchronize()
        for name in ("adj_bucket_kernel", second):
            us = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
            check(us > 0, f"the profile of {fn.__name__} shows no {name}")
            split[fn.__name__, name] = us / 1e3 / calls
    return {"split": split,
            "adj_count": cuda_ms(lambda: adj_count(es, ed, ew, B, Ln), 20),
            "adj_count_onehot": cuda_ms(lambda: adj_count_onehot(es, ed, ew, B, Ln), 20),
            "plain": cuda_ms(lambda: adj_count_reference(es, ed, ew, B, Ln), 5),
            "index_put": cuda_ms(index_put, 5),
            "onehot_bmm": cuda_ms(onehot_bmm, 5)}


# -------------------------------------------------------------- main path --

def build_dataset(seed: int, n_codes: int, num_kg_nodes: int = 130_000,
                  num_edges: int = 4_000_000):
    import numpy as np

    from medtok_tpu_torch.config import DataConfig
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.synthetic import (
        MEDICAL_WORDS,
        SYLLABLES,
        synthetic_kg,
        synthetic_vocab_columns,
    )
    from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab

    rng = np.random.default_rng(seed)
    cols = synthetic_vocab_columns(rng, num_codes=n_codes, num_kg_nodes=num_kg_nodes,
                                   heavy_tail=True)
    kg = synthetic_kg(rng, num_nodes=num_kg_nodes, num_edges=num_edges,
                      local_frac=0.7, local_window=64)
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    # the export sweep's buckets: fine text buckets, node/edge buckets that
    # carry the heavy subgraph tail; packed rows are [256, 128]
    cfg = DataConfig(text_buckets=(8, 16, 24, 32, 48, 64), node_buckets=(16, 128, 512),
                     edge_buckets=(32, 1024, 8192), max_text_length=64)
    return MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab), cfg=cfg)


def run_main_path(model, dataset, dev) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from medtok_tpu_torch.export import export_all_packed, export_groups
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    n = len(dataset)
    steps = len(export_groups(dataset))
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = export_all_packed(model, dataset, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"topk_l2": fused_topk_l2.launches,
                "segment_attention": packed_segment_attention.launches}
    n_layers = model.cfg.text.num_layers
    check(launches["segment_attention"] == n_layers * steps,
          f"K2 launches {launches['segment_attention']} != {n_layers} x {steps} BERT steps")
    check(launches["topk_l2"] == 4 * steps,
          f"K1 launches {launches['topk_l2']} != 4 x {steps} quantizer steps")
    emb, tok, w = arrays["embeddings_all"], arrays["tokens_all"], arrays["weights_all"]
    check(emb.shape == (n, 256) and tok.shape == (n, 4, K) and w.shape == (n, 4, K),
          f"output shapes {emb.shape} {tok.shape} {w.shape}")
    check(bool(np.isfinite(emb).all() and np.isfinite(w).all()), "non-finite outputs")
    n_e = model.cfg.quantizer.codebook_size
    check(bool((tok[:, 2:] >= 0).all() and (tok[:, 2:] < n_e).all()),
          "shared tokens out of [0, 21000)")
    check(bool((tok[:, :2] >= 0).all() and (tok[:, :2] < n_e // 3).all()),
          "specific tokens out of [0, 7000)")
    check(bool(np.allclose(w.sum(-1), 1.0, atol=1e-4)), "weights do not sum to 1")
    log(f"main path: {n} codes in {steps} steps, {wall:.3f} s wall "
        f"({n / wall:.1f} codes/s), launches {launches}")
    return launches, arrays


def profile_main_path(model, dataset, dev, first: dict) -> None:
    """Where the export's time goes: the same sweep again under
    torch.profiler, read per export.* range (host time on the CPU side, span
    of its kernels on the GPU side) and per device kernel. The second sweep
    must also reproduce the first bit for bit."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from medtok_tpu_torch.export import export_all_packed
    from medtok_tpu_torch.ops import vq

    def dev_us(e):
        return e.self_device_time_total

    # the (z rows, codebook rows) of each K1 call, in launch order
    shapes = []
    distance_topk = vq.distance_topk

    def recorded(z_n, e_n, k, **kw):
        shapes.append((z_n.shape[0], e_n.shape[0]))
        return distance_topk(z_n, e_n, k, **kw)

    torch.cuda.synchronize()
    vq.distance_topk = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            again = export_all_packed(model, dataset, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        vq.distance_topk = distance_topk
    for name, arr in first.items():
        check(np.array_equal(arr, again[name]), f"a second export changed {name}")
    on_gpu = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    ranges = [e for e in events if e.key.startswith("export.") or e.key == "gcn_norm_adj"]
    device = [e for e in events if e.device_type == on_gpu and e not in ranges]
    copies = sum(dev_us(e) for e in device if e.key.startswith("Memcpy"))
    kernels = sum(dev_us(e) for e in device if not e.key.startswith("Memcpy"))
    log(f"profile: second export {wall:.3f} s wall under the profiler (bitwise "
        f"equal to the first); device kernels {kernels / 1e6:.3f} s "
        f"({100 * kernels / 1e6 / wall:.1f}% of wall), copies {copies / 1e6:.3f} s")
    # the dense-adjacency Count (gcn_norm_adj runs at node buckets >= 64)
    count = [e for e in ranges if e.key == "gcn_norm_adj" and e.device_type == on_gpu]
    count_us = sum(dev_us(e) for e in count)
    log(f"profile: Count build (gcn_norm_adj, tail node buckets) gpu span "
        f"{count_us / 1e3:.3f} ms over {sum(e.count for e in count)} calls, "
        f"{100 * count_us / max(kernels, 1.0):.2f}% of the device kernel time")
    k2 = [e for e in device if "segment_attention" in e.key]
    check(bool(k2), "profile: no K2 kernel in the export's trace")
    k2_us = sum(dev_us(e) for e in k2)
    log(f"profile: K2 device time {k2_us / 1e3:.3f} ms over {sum(e.count for e in k2)} "
        f"launches, {100 * k2_us / max(kernels, 1.0):.2f}% of the device kernel time")
    k1_profile(prof.events(), shapes, kernels)
    for e in sorted(ranges, key=lambda e: (e.device_type == on_gpu, e.key)):
        side = "gpu span" if e.device_type == on_gpu else "host"
        t = dev_us(e) if e.device_type == on_gpu else e.cpu_time_total
        log(f"  {e.key:18s} {side:8s} {t / 1e6:8.3f} s  calls {e.count}")
    for e in sorted(device, key=lambda e: -dev_us(e))[:10]:
        log(f"  device {dev_us(e) / 1e3:9.2f} ms x{e.count:<5d} {e.key[:100]}")


def k1_profile(events, shapes, kernels_us: float) -> None:
    """K1's launches and summed device time per shape (z rows x codebook
    rows) in a profiled export: the device events of K1's kernels in start
    order, one call from each split kernel to the next, matched to the
    calls' shapes in launch order (one stream, so the orders agree)."""
    import collections

    import torch

    names = ("tf32_split_kernel", "topk_tf32_kernel", "topk_merge_kernel")
    k1 = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.name for n in names)), key=lambda e: e.time_range.start)
    calls = []
    for e in k1:
        if names[0] in e.name:
            calls.append(0.0)
        check(bool(calls), f"profile: K1 kernel {e.name[:60]} before any split kernel")
        calls[-1] += e.device_time_total
    check(len(calls) == len(shapes),
          f"profile: {len(calls)} K1 calls on the device, {len(shapes)} made")
    per = collections.defaultdict(lambda: [0, 0.0])
    for shape, us in zip(shapes, calls):
        per[shape][0] += 1
        per[shape][1] += us
    total = sum(calls)
    log(f"profile: K1 {len(calls)} launches, device time {total / 1e3:.3f} ms, "
        f"{100 * total / max(kernels_us, 1.0):.2f}% of the device kernel time; per shape:")
    for (b, n), (count, us) in sorted(per.items()):
        log(f"  K1 z [{b}, {D}] x e [{n}, {D}]: {count} launches, {us / 1e3:.3f} ms "
            f"({us / 1e3 / count:.4f} ms a launch)")


def tie_gaps(tok, w, ref_tok, ref_w):
    """The tie gap of every token row [.., K] that differs from the
    reference row, read from the softmax weights: -ln w_j is distance j plus
    a per-row constant. An order swap's gap is the reference's distance
    between the swapped picks. A pick outside the reference's top K gets
    docs/PARITY.md's boundary gap, its distance minus the reference's K-th,
    with the two rows aligned on a codeword both picked (inf if none)."""
    import numpy as np

    tok, ref_tok = tok.reshape(-1, K), ref_tok.reshape(-1, K)
    d = -np.log(w.reshape(-1, K).astype(np.float64))
    ref_d = -np.log(ref_w.reshape(-1, K).astype(np.float64))
    gaps = []
    for r in np.flatnonzero((tok != ref_tok).any(axis=1)):
        t, rt = tok[r].tolist(), ref_tok[r].tolist()
        if sorted(t) == sorted(rt):
            gaps.append(max(abs(ref_d[r, rt.index(a)] - ref_d[r, i])
                            for i, a in enumerate(t) if a != rt[i]))
            continue
        common = [a for a in t if a in rt]
        if not common:
            gaps.append(np.inf)
            continue
        shift = d[r, t.index(common[0])] - ref_d[r, rt.index(common[0])]
        gaps.append(max(d[r, i] - shift - ref_d[r, K - 1]
                        for i, a in enumerate(t) if a not in rt))
    return np.asarray(gaps)


def check_reference(model, dataset, dev, n_codes: int = 64,
                    label: str = "fp32 reference") -> None:
    """A small fp32 export with the kernels on the card against the same
    export with the plain versions on the CPU. Token rows may differ only
    where the reference's picks are tied to within 1e-5 (docs/PARITY.md);
    embeddings are compared on the paths whose tokens agree."""
    import dataclasses

    import numpy as np
    import torch

    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.export import export_all_packed
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    sub = MedCodeDataset(dataset.kg, dataset.med_codes[:n_codes], dataset.descs[:n_codes],
                         dataset.pkg_index_lists[:n_codes], dataset.tokenizer,
                         cfg=dataset.cfg)
    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    state = {k: v.float() for k, v in model.state_dict().items()}
    out = []
    for where in (dev, torch.device("cpu")):
        m = MultimodalTokenizer(cfg32, device=where)
        m.load_state_dict(state)
        out.append(export_all_packed(m, sub, device=where, num_rows=8))
        del m
    got, want = out
    rows_equal = (got["tokens_all"] == want["tokens_all"]).all(axis=-1)   # [n, 4]
    gaps = tie_gaps(got["tokens_all"], got["weights_all"],
                    want["tokens_all"], want["weights_all"])
    max_gap = float(gaps.max(initial=0.0))
    # embedding part p (one per path) compared on the rows whose path-p tokens agree
    d = cfg32.quantizer.codebook_embed_dim
    emb_err = max(
        (float(np.abs(got["embeddings_all"][rows_equal[:, p], d * p:d * (p + 1)]
                      - want["embeddings_all"][rows_equal[:, p], d * p:d * (p + 1)]).max())
         for p in range(4) if rows_equal[:, p].any()), default=0.0)
    check(max_gap <= 1e-5, f"{label}: token rows differ beyond a tie "
          f"(gaps {gaps.tolist()} > 1e-5)")
    check(emb_err <= 1e-4, f"{label}: embedding error {emb_err} > 1e-4")
    log(f"{label} ({n_codes} codes, kernels on the card vs plain on the "
        f"CPU): {int((~rows_equal).sum())}/{rows_equal.size} token rows differ, "
        f"max tie gap {max_gap:.3e}; embedding max err {emb_err:.3e} on the "
        f"other rows")


def serve_requests(cfg, model, dataset, dev) -> dict:
    from medtok_tpu_torch.api import MedTok
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    api = MedTok(cfg, model, dataset, device=dev)
    codes = [dataset.code_at(i) for i in (0, len(dataset) // 2, len(dataset) - 1)]
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    t0 = time.perf_counter()
    for c in codes:
        t, e, emb = api.tokenize(c), api.encode(c), api.embed(c)
        check(t.shape == (4, K) and e.shape == (4 * K,) and emb.shape == (256,),
              f"API shapes for {c}")
        check((t.reshape(-1) == e).all(), f"encode != flat tokenize for {c}")
    wall = time.perf_counter() - t0
    launches = {"topk_l2": fused_topk_l2.launches,
                "segment_attention": packed_segment_attention.launches}
    check(launches["topk_l2"] == 4 * 3 * len(codes),
          f"API: K1 launches {launches['topk_l2']} != 4 per request")
    log(f"API: {3 * len(codes)} requests for {codes} in {wall:.3f} s, launches {launches}")
    return launches


# ---------------------------------------------------------------- EHR -----

ETHNICITIES = ("WHITE", "BLACK", "ASIAN", "HISPANIC", "OTHER")


def ehr_samples(rng, n: int, vocab: int, max_codes: int) -> list[list[dict]]:
    """n readmission samples in the schema of the JAX package's
    PatientEHRTasks.build: per visit, sorted unique code rows (-1 =
    unmapped) for conditions / procedures / drugs, encounter and discharge
    times, birthdate, gender, ethnicity and a 0/1 label. A patient's code
    count is uniform in [max_codes / 4, max_codes), as bench.py's
    ehr_train_step draws it for its batch at the reference shape; the codes
    are distinct within a patient and a visit holds at most one unmapped
    code, so featurizing keeps every one of them."""
    import numpy as np

    base = datetime.datetime(2130, 1, 1)
    out = []
    for i in range(n):
        total = int(rng.integers(max_codes // 4, max_codes))
        n_visits = int(rng.integers(1, min(100, total) + 1))
        codes = rng.choice(vocab, size=total, replace=False)
        cuts = np.sort(rng.choice(np.arange(1, total), size=n_visits - 1, replace=False))
        maps = ([], [], [])
        for visit in np.split(codes, cuts):
            if rng.random() < 0.3:
                visit[0] = -1
            a, b = len(visit) // 2, (3 * len(visit)) // 4
            for m, part in zip(maps, (visit[:a], visit[a:b], visit[b:])):
                m.append(sorted(set(part.tolist())))
        t = base + datetime.timedelta(days=int(rng.integers(0, 3000)))
        enc, dis = [], []
        for _ in range(n_visits):
            enc.append(t)
            dis.append(t + datetime.timedelta(hours=int(rng.integers(2, 24 * 30))))
            t = dis[-1] + datetime.timedelta(days=int(rng.integers(1, 400)))
        out.append([{
            "patient_id": i,
            "birthdate": base - datetime.timedelta(days=int(rng.integers(18 * 365, 90 * 365))),
            "deathdate": None,
            "gender": ("M", "F")[int(rng.integers(2))],
            "ethnicity": ETHNICITIES[int(rng.integers(len(ETHNICITIES)))],
            "conditions_map": [maps[0]], "procedures_map": [maps[1]],
            "drugs_map": [maps[2]],
            "label": int(rng.random() < 0.3),
            "timestamp_encounter": enc, "timestamp_discharge": dis,
        }])
    return out


def build_ehr_data(seed: int, vocab: int, batch: int) -> dict:
    import numpy as np

    from medtok_tpu_torch.ehr.train import EHRTrainConfig, prepare_task_features

    cfg = EHRTrainConfig()
    rng = np.random.default_rng(seed + 1)
    n_train = EHR_TRAIN_STEPS * batch
    n = n_train + (1 + EHR_EVAL_BATCHES) * batch
    t0 = time.perf_counter()
    data = ehr_samples(rng, n, vocab, cfg.max_medical_code)
    t_make = time.perf_counter() - t0
    labels = np.asarray([d[0]["label"] for d in data])
    t0 = time.perf_counter()
    feats, fz = prepare_task_features(data, labels, 2, "readmission", vocab_size=vocab,
                                      max_visits=cfg.max_visits,
                                      max_medical_code=cfg.max_medical_code)
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = fz.collate(feats[n_train:n_train + batch])
    t_collate = time.perf_counter() - t0
    rest = feats[n_train + batch:]
    lens = np.asarray([int((~f["pad_mask"]).sum()) for f in feats])
    log(f"EHR data: {n} samples in {t_make:.2f} s, featurized in {t_feat:.2f} s "
        f"({1e3 * t_feat / n:.3f} ms/sample), collate {1e3 * t_collate:.1f} ms per "
        f"batch of {batch}; codes per sample {lens.min()}-{lens.max()} (median "
        f"{int(np.median(lens))}, uniform in [{cfg.max_medical_code // 4}, "
        f"{cfg.max_medical_code}) as in bench.py's ehr_train_step)")
    return dict(feats_train=feats[:n_train], labels_train=labels[:n_train], fz=fz,
                val=[val], eval=[fz.collate(rest[i * batch:(i + 1) * batch])
                                 for i in range(EHR_EVAL_BATCHES)],
                featurize_ms=1e3 * t_feat / n * batch, collate_ms=1e3 * t_collate)


def key_mask_of(batch, dev):
    """The encoder's [B, 3 + C] key mask: CLS, gender, ethnicity, codes."""
    import torch

    pad = torch.from_numpy(batch.pad_mask).to(dev)
    return torch.cat([torch.ones(pad.shape[0], 3, dtype=torch.bool, device=dev), ~pad], 1)


# --------------------------------------------------------------------- K3 --

def sm_clock_hz() -> float:
    """The card's largest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def check_k3_fp32(gen, dev, mask, kw, Dh: int = 16) -> dict:
    """K3 in fp32 through autograd against autograd through the plain
    version, in slices of K3_SLICE batch rows, at head width Dh: out / dq /
    dk / dv within 1e-5 / 1e-4 of the plain version's largest value, lse
    within 1e-4. Returns the largest absolute errors."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa

    Bf, L = mask.shape
    H, S = K3_HEADS, K3_SLICE
    keys = ("out", "lse", "dq", "dk", "dv")
    q, k, v, do = (torch.randn(Bf, H, L, Dh, generator=gen, device=dev) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, mask, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*leaves, mask, **kw) * do).sum().backward()
    got = dict(zip(keys, (out, lse, *(t.grad for t in leaves))))
    diff, scale = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    for b0 in range(0, Bf, S):
        rows = slice(b0, b0 + S)
        part = [t[rows].clone().requires_grad_() for t in (q, k, v)]
        ref, ref_lse = fa.flash_attention_reference(*part, mask[rows], **kw, bh_offset=b0 * H)
        (ref * do[rows]).sum().backward()
        want = dict(zip(keys, (ref, ref_lse, *(t.grad for t in part))))
        for key in keys:
            w = want[key].detach()
            diff[key] = max(diff[key], float((got[key][rows] - w).abs().max()))
            scale[key] = max(scale[key], float(w.abs().max()))
        del part, ref, ref_lse, want
    torch.cuda.synchronize()
    e = {key: diff[key] / scale[key] for key in ("out", "dq", "dk", "dv")}
    check(e["out"] <= 1e-5, f"K3 float32: out error {e['out']} > 1e-5")
    check(diff["lse"] <= 1e-4, f"K3 float32: lse error {diff['lse']} > 1e-4")
    for g in ("dq", "dk", "dv"):
        check(e[g] <= 1e-4, f"K3 float32: {g} error {e[g]} > 1e-4")
    check(bool((out[-1] == 0).all() and (lse[-1] == -1e30).all()),
          "K3 float32: the row with no valid key is not 0 / -1e30")
    check(all(bool((got[g][-1] == 0).all()) for g in ("dq", "dk", "dv")),
          "K3 float32: the row with no valid key has non-zero gradients")
    log(f"K3 float32 [{Bf}*{H}, {L}, {Dh}] dropout {kw['dropout_rate']}, "
        f"{float(mask.float().mean()):.3f} of the keys valid, plain version in slices of "
        f"{S} batch rows: errors relative to the plain version's max: out {e['out']:.3e}, "
        f"dq {e['dq']:.3e}, dk {e['dk']:.3e}, dv {e['dv']:.3e}; lse max abs err "
        f"{diff['lse']:.3e}; the row with no valid key is 0 with zero gradients")
    return {"out": diff["out"], "dq": diff["dq"], "dkv": max(diff["dk"], diff["dv"])}


def check_k3_bf16(q, k, v, do, mask, kw, label: str) -> dict:
    """K3's bf16 kernels, each against its plain version on the same inputs
    (dq and dk/dv on the kernel's own lse and D = dO . out), in slices of
    K3_SLICE batch rows: every element by Bf16Tally's rule (for the
    gradients 2^-7 times the sum of their terms' magnitudes, e.g.
    sm_scale |ds| |k| for dq, + 1e-6), under 1% differing; lse within 1e-4. Two backward passes must be bitwise equal
    and equal to the gradients through the autograd Function. A batch row
    whose mask is all False must give 0, lse -1e30 and zero gradients.
    Returns the largest absolute errors."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa

    Bf, H, Lq, Dh = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, mask, **kw)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, mask, lse, delta, do)
    dq = fa.flash_attention_dq(*bwd, **kw)
    dk, dv = fa.flash_attention_dkv(*bwd, **kw)
    again = (fa.flash_attention_dq(*bwd, **kw), *fa.flash_attention_dkv(*bwd, **kw))
    check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
          f"K3 bf16 {label}: two backward passes differ")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, mask, **kw)
    o.backward(do)
    check(torch.equal(o, out) and all(torch.equal(t.grad, g)
                                      for t, g in zip(leaves, (dq, dk, dv))),
          f"K3 bf16 {label}: the autograd Function's gradients differ from the kernels'")
    tallies = {"out": Bf16Tally(), **{key: Bf16Tally(value_ulp=False)
                                       for key in ("dq", "dk", "dv")}}
    lse_err = 0.0
    for b0 in range(0, Bf, K3_SLICE):
        rows = slice(b0, b0 + K3_SLICE)
        part = dict(kw, bh_offset=b0 * H)
        want, want_lse = fa.flash_attention_reference(q[rows], k[rows], v[rows], mask[rows],
                                                      **part)
        terms, _ = fa.flash_attention_reference(q[rows].float(), k[rows].float(),
                                                v[rows].float().abs(), mask[rows], **part)
        tallies["out"].add(out[rows], want, terms)
        lse_err = max(lse_err, float((lse[rows] - want_lse).abs().max()))
        args = [t[rows] for t in bwd]
        want_dq = fa.flash_attention_dq_reference(*args, **part)
        want_dk, want_dv = fa.flash_attention_dkv_reference(*args, **part)
        t_dq, t_dk, t_dv = fa.flash_attention_grad_terms(*args, **part)
        for key, got, w, t in (("dq", dq, want_dq, t_dq), ("dk", dk, want_dk, t_dk),
                               ("dv", dv, want_dv, t_dv)):
            tallies[key].add(got[rows], w, t)
        del want, terms, want_dq, want_dk, want_dv, t_dq, t_dk, t_dv
    torch.cuda.synchronize()
    res = {key: tally.check(f"K3 bf16 {label} {key}") for key, tally in tallies.items()}
    check(lse_err <= 1e-4, f"K3 bf16 {label}: lse error {lse_err} > 1e-4")
    empty = ~mask.any(dim=1)
    check(bool((out[empty] == 0).all() and (lse[empty] == -1e30).all()),
          f"K3 bf16 {label}: a row with no valid key is not 0 / -1e30")
    check(all(bool((g[empty] == 0).all()) for g in (dq, dk, dv)),
          f"K3 bf16 {label}: a row with no valid key has non-zero gradients")
    log(f"K3 bf16 {label} q [{Bf}*{H}, {Lq}, {Dh}], k/v Lk {k.shape[2]}, dropout "
        f"{kw['dropout_rate']}, {float(mask.float().mean()):.3f} of the keys valid, "
        f"{int(empty.sum())} rows with none; vs the bf16 plain version on the same "
        f"inputs: " + ", ".join(f"{key} {100 * r['share']:.4f}% differ (max abs "
                                f"{r['max_abs']:.3e}, {r['beyond_ulp']} beyond one ulp of "
                                f"the value)" for key, r in res.items())
        + f", 0 beyond the tolerance; lse max abs err {lse_err:.3e}; two backward passes "
        f"and the autograd Function bitwise equal")
    return {"out": res["out"]["max_abs"], "dq": res["dq"]["max_abs"],
            "dkv": max(res["dk"]["max_abs"], res["dv"]["max_abs"])}


def k3_edge_masks(dev, B: int, Lk: int):
    """[B, Lk] key masks the EHR batches never make, for the tile skip and
    the tails: holes (every third key, and a run of Lk / 2 keys from Lk / 3,
    so that whole key tiles of dq and key blocks of dkv are skipped between
    ones that are part valid), a suffix of padding, alternate keys, and the
    last row with no valid key."""
    import torch

    j = torch.arange(Lk, device=dev)
    holes = (j % 3 != 1) & ~((j >= Lk // 3) & (j < Lk // 3 + Lk // 2))
    rows = [holes, j < (2 * Lk) // 3] + [j % 2 == 0] * (B - 3) + [torch.zeros_like(holes)]
    return torch.stack(rows)


def check_k3(gen, dev, mask_path) -> list[dict]:
    """Kernels vs plain versions at the EHR shape, then edge cases through
    the bf16 route, then times.
    mask_path: the [256, 2003] key mask of an EHR batch of the main path."""
    import torch
    import torch.nn.functional as F

    from medtok_tpu_torch.ops import flash_attention as fa

    Bf, L = mask_path.shape
    H, Dh, rate = K3_HEADS, 16, 0.5
    mask = mask_path.clone()
    mask[-1] = False                                   # a row with no valid key
    kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=rate, dropout_seed=K3_SEED)
    t0 = time.perf_counter()
    errs = {"float32": check_k3_fp32(gen, dev, mask, kw)}
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(Bf, H, L, Dh, generator=gen, device=dev).to(bf)
                   for _ in range(4))
    errs["bfloat16"] = check_k3_bf16(q, k, v, do, mask, kw, "EHR shape")
    del q, k, v, do
    # Lq != Lk, lengths that are no multiple of 16 or 64, masks with holes
    for Lq, Lk, p in ((100, 700, rate), (700, 100, rate), (100, 700, 0.0)):
        B = 4
        q, do = (torch.randn(B, H, Lq, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        k, v = (torch.randn(B, H, Lk, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        check_k3_bf16(q, k, v, do, k3_edge_masks(dev, B, Lk), dict(kw, dropout_rate=p),
                      f"edge Lq={Lq} Lk={Lk}")
    log(f"K3 check: {time.perf_counter() - t0:.2f} s")

    # times at the EHR shape in bf16, on the path's mask and on an all-valid one
    q, k, v, do = (torch.randn(Bf, H, L, Dh, generator=gen, device=dev).to(bf)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    props = torch.cuda.get_device_properties(dev)
    clock = sm_clock_hz()
    rows = []
    for label, m in (("path", mask_path), ("all-valid", torch.ones_like(mask_path))):
        out, lse = fa.flash_attention_fwd(q, k, v, m, **kw)
        delta = (do.float() * out.float()).sum(-1)
        bwd = (q, k, v, m, lse, delta, do)
        ms = {"fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, m, **kw), 10),
              "dq": cuda_ms(lambda: fa.flash_attention_dq(*bwd, **kw), 10),
              "dkv": cuda_ms(lambda: fa.flash_attention_dkv(*bwd, **kw), 10)}
        sdpa_mask = m[:, None, None, :]
        lib = {}
        for p in (0.0, rate):
            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask, dropout_p=p)
                return torch.autograd.grad(o, leaves, do)

            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, dropout_p=p), 10)
            lib[p] = (fwd, cuda_ms(sdpa_fwd_bwd, 10))
        valid_keys = float(m.sum())                    # sum over rows of valid keys
        pairs = H * L * valid_keys                     # (query, valid key): the scores
        row = Bf * H * L * Dh * 2                      # one bf16 [B*H, L, Dh] tensor
        vec = Bf * H * L * 4                           # one fp32 [B*H, L] vector
        work = {"fwd": (4 * Dh * pairs, 3 * row + Bf * L + row + vec),
                "dq": (6 * Dh * pairs, 4 * row + 2 * vec + Bf * L + row),
                "dkv": (8 * Dh * pairs, 4 * row + 2 * vec + Bf * L + 2 * row)}
        # one exp a score on the SFU (16 a clock per SM), and the issue
        # slots of the backward's per-score CUDA-core work (4 warp
        # instructions a clock per SM)
        exp_ms = pairs / (props.multi_processor_count * 16 * clock) * 1e3
        issue_ms = {key: pairs * n / (props.multi_processor_count * 128 * clock) * 1e3
                    for key, n in K3_SLOTS.items()}
        log(f"K3 bf16 [{Bf}*{H}, {L}, {Dh}] dropout {rate}, {label} mask "
            f"({valid_keys / (Bf * L):.3f} of the keys valid, {pairs / 1e9:.3f}e9 scores); "
            f"library scaled_dot_product_attention with the boolean key mask: no dropout fwd "
            f"{lib[0.0][0]:.4f} ms, fwd+bwd {lib[0.0][1]:.4f} ms; dropout {rate} fwd "
            f"{lib[rate][0]:.4f} ms, fwd+bwd {lib[rate][1]:.4f} ms (its backward "
            f"computes dq, dk and dv together); per-score floors at "
            f"{props.multi_processor_count} SMs and {clock / 1e9:.3f} GHz: exp {exp_ms:.4f} ms, "
            + ", ".join(f"issue {key} {issue_ms[key]:.4f} ms ({n} slots)"
                        for key, n in K3_SLOTS.items()))
        if label == "path":
            # the plain versions over the whole batch, a slice of S rows at a time
            def sliced(fn, tensors):
                def run():
                    for b0 in range(0, Bf, K3_SLICE):
                        fn(*(t[b0:b0 + K3_SLICE] for t in tensors), **kw, bh_offset=b0 * H)
                return run

            plain = {"fwd": cuda_ms(sliced(fa.flash_attention_reference, bwd[:4]), 2),
                     "dq": cuda_ms(sliced(fa.flash_attention_dq_reference, bwd), 2),
                     "dkv": cuda_ms(sliced(fa.flash_attention_dkv_reference, bwd), 2)}
        lib_ms = {"fwd": lib[rate][0], "dq": lib[rate][1] - lib[rate][0],
                  "dkv": lib[rate][1] - lib[rate][0]}
        for key, name, site, err in (("fwd", "flash_attention_fwd", 249, "out"),
                                     ("dq", "flash_attention_dq", 311, "dq"),
                                     ("dkv", "flash_attention_dkv", 334, "dkv")):
            ops, nbytes = work[key]
            bound_ms = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
            log(f"  K3-{key} ({label}): kernel {ms[key]:.4f} ms, "
                + (f"plain {plain[key]:.4f} ms, " if label == "path" else "")
                + f"library {lib_ms[key]:.4f} ms, bound {bound_ms:.4f} ms "
                f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); kernel "
                f"{ms[key] / max(exp_ms, issue_ms[key]):.2f}x its per-score floor")
            if label == "path":
                rows.append(dict(name=name, route="cuda",
                                 source="medtok_tpu_torch/csrc/flash_attention.cu",
                                 replaces=f"medtok_tpu/ops/flash_attention.py:{site}",
                                 max_abs_err=errs["bfloat16"][err], ms=ms[key],
                                 plain_ms=plain[key], bound_ms=bound_ms,
                                 bound_by="operations" if ops / PEAK_BF16 > nbytes / PEAK_BYTES
                                 else "bytes",
                                 library_ms=lib_ms[key]))
        log(f"  K3 backward ({label}): dq + dkv {ms['dq'] + ms['dkv']:.4f} ms vs the "
            f"library's backward {lib_ms['dq']:.4f} ms: "
            + ("faster" if ms["dq"] + ms["dkv"] < lib_ms["dq"] else "slower")
            + f"; K3-fwd {ms['fwd']:.4f} ms vs the library's forward {lib_ms['fwd']:.4f} "
            f"ms: " + ("faster" if ms["fwd"] < lib_ms["fwd"] else "slower"))
    return rows


def k3_counts() -> dict:
    from medtok_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd.launches, "dq": fa.flash_attention_dq.launches,
            "dkv": fa.flash_attention_dkv.launches}


def run_ehr(table, ehr: dict, dev) -> tuple[dict, object]:
    """EHRTrainer.fit for one epoch and evaluate on two batches at the
    reference width, counting K3 launches; then a timed and a profiled
    train step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer, sample_weights
    from medtok_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(EHRTrainConfig(), epochs=1)
    trainer = EHRTrainer(cfg, table, 2, device=dev)
    check(trainer.use_flash, "EHR: flash_attention='auto' did not pick K3 on the card")
    n_layers = cfg.num_layers
    steps = len(ehr["feats_train"]) // cfg.batch_size
    n_params = sum(p.numel() for p in trainer.model.parameters())
    losses = []
    for f in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv):
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, best = trainer.fit(ehr["feats_train"],
                          sample_weights(ehr["labels_train"], "readmission"),
                          ehr["val"], ehr["fz"],
                          log_fn=lambda e, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = k3_counts()
    want = {"fwd": n_layers * (steps + len(ehr["val"])), "dq": n_layers * steps,
            "dkv": n_layers * steps}
    check(fit_counts == want, f"EHR fit: K3 launches {fit_counts} != {want} "
          f"({n_layers} per layer for {steps} train steps and {len(ehr['val'])} "
          f"validation batches)")
    t0 = time.perf_counter()
    metrics = trainer.evaluate(ehr["eval"])
    eval_wall = time.perf_counter() - t0
    counts = k3_counts()
    check(counts["fwd"] - fit_counts["fwd"] == n_layers * len(ehr["eval"])
          and counts["dq"] == fit_counts["dq"],
          f"EHR evaluate: K3 launches {counts} after {fit_counts}")
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == 1 and np.isfinite(losses[0]), f"EHR: loss {losses}")
    for m in (best, metrics):
        check(all(0.0 <= m[key] <= 1.0 for key in ("auc", "aupr", "f1")),
              f"EHR: metrics out of [0, 1]: {m}")
    log(f"EHR model: EHRTrainConfig() width, {n_params / 1e6:.3f} M parameters, "
        f"K3 {'on' if trainer.use_flash else 'off'} ({cfg.flash_precision}), table "
        f"{tuple(table.shape)}")
    log(f"EHR fit: {steps} train steps + validation in {fit_wall:.3f} s, loss "
        f"{losses[0]:.5f}, val {best}; evaluate on {len(ehr['eval'])} batches "
        f"{eval_wall:.3f} s: {metrics}; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {counts}")

    def step_seconds(batch, n_timed: int = 3) -> float:
        trainer.train_step(batch)                      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            loss, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), "EHR: non-finite loss in the timed steps")
        return (time.perf_counter() - t0) / n_timed

    batch = ehr["eval"][0]
    step_s = step_seconds(batch)
    full_s = step_seconds(batch._replace(pad_mask=np.zeros_like(batch.pad_mask)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    on_gpu = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.key_averages() if e.device_type == on_gpu]
    groups = {"K3": 0.0, "GEMM": 0.0, "copies": 0.0, "other": 0.0}
    for e in device:
        key = e.key.lower()
        group = ("K3" if "flash_" in key else
                 "copies" if key.startswith("memcpy") else
                 "GEMM" if any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma"))
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    valid = 1.0 - float(batch.pad_mask.mean())
    log(f"EHR train step (batch {cfg.batch_size}, {cfg.max_medical_code + 3} positions, "
        f"{valid:.3f} of the codes valid): {1e3 * step_s:.3f} ms, "
        f"{cfg.batch_size / step_s:.1f} samples/s; on an all-valid batch "
        f"{1e3 * full_s:.3f} ms, {cfg.batch_size / full_s:.1f} samples/s; host featurize "
        f"{ehr['featurize_ms']:.1f} ms + collate {ehr['collate_ms']:.1f} ms per batch "
        f"(outside the step)")
    log(f"profile: one train step {1e3 * prof_wall:.3f} ms wall; device "
        + ", ".join(f"{g} {ms:.3f} ms ({100 * ms / (1e3 * prof_wall):.1f}%)"
                    for g, ms in groups.items())
        + f"; device busy {100 * busy / (1e3 * prof_wall):.1f}% of wall")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:90]}")
    return counts, trainer


def check_ehr_reference(trainer, ehr: dict, dev, n: int = 8) -> None:
    """The trained model's eval logits with K3 on the card against the plain
    versions on the CPU (same weights, same batch), under "highest" (K3 in
    fp32) and the path's "default" (q/k/v enter K3 in bf16)."""
    import torch

    from medtok_tpu_torch.ehr.model import EHRModel, to_device

    cfg = trainer.cfg
    first = ehr["eval"][0]
    batch = type(first)(*(x[:n] for x in first))
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    table = trainer.model.embedding_table.cpu().numpy()
    # "default": both sides round q/k/v and the probabilities to bf16 (against
    # the running max of 512-key blocks), but the fp32 scores and sums come
    # out of the kernel and of the CPU in another order
    for precision, tol in (("highest", 1e-4), ("default", 2e-2)):
        logits = []
        for where in (dev, torch.device("cpu")):
            model = EHRModel(table, trainer.num_class, input_dim=cfg.input_dim,
                             output_dim=cfg.output_dim, num_heads=cfg.num_heads,
                             hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                             use_flash=True, flash_precision=precision)
            model.load_state_dict(state)
            with torch.no_grad():
                logits.append(model.to(where).eval()(to_device(batch, where))[1].cpu())
        err = float((logits[0] - logits[1]).abs().max())
        rel = err / max(float(logits[1].abs().max()), 1e-30)
        check(bool(torch.isfinite(logits[0]).all()) and rel <= tol,
              f"EHR reference ({precision}): logits error {rel} relative > {tol}")
        log(f"EHR reference, {precision} ({n} samples, K3 on the card vs plain on the "
            f"CPU): logits max abs err {err:.3e}, {rel:.3e} of the largest logit")


# ---------------------------------------------------------------- slice 3 --

def run_slice3() -> dict:
    """The packed-BERT probe and the Count A/B at their full default
    shapes, each with the launch counters set to 0 just before it; returns
    the launches of K4, K5 and K5-lane."""
    from medtok_tpu_torch.ops.adj_count import adj_count, adj_count_onehot
    from medtok_tpu_torch.ops.flash_attention import (
        packed_segment_attention,
        packed_segment_attention_nt,
    )
    from medtok_tpu_torch.scripts import bench_adj, profile_bert

    packed_segment_attention.launches = 0
    packed_segment_attention_nt.launches = 0
    t0 = time.perf_counter()
    prof = profile_bert.main([])
    wall = time.perf_counter() - t0
    launches = {"segment_attention_nt": packed_segment_attention_nt.launches}
    per_call = prof["launches_per_call"]
    for leg, want in (("full_flash", (12, 0)), ("kernel_only", (12, 0)),
                      ("kernel_nt_only", (0, 12)), ("full", (0, 0))):
        got = (per_call[leg]["segment_attention"], per_call[leg]["segment_attention_nt"])
        check(got == want, f"profile_bert {leg}: (K2, K4) launches per call {got} != {want}")
    legs = [k for k in prof if k.endswith("_ms")]
    check(len(legs) == 11 and all(0 < prof[k] < float("inf") for k in legs),
          f"profile_bert: leg times {[prof[k] for k in legs]}")
    check(launches["segment_attention_nt"] > 0, "profile_bert launched no K4")
    log(f"profile_bert: {wall:.2f} s, {packed_segment_attention.launches} K2 and "
        f"{launches['segment_attention_nt']} K4 launches")

    adj_count.launches = 0
    adj_count_onehot.launches = 0
    t0 = time.perf_counter()
    adj = bench_adj.main(["--variants", "bf16_chunked,int8,cuda_count,cuda_onehot"])
    wall = time.perf_counter() - t0
    launches.update(adj_count=adj_count.launches, adj_count_onehot=adj_count_onehot.launches)
    for name in bench_adj.VARIANTS:
        check("error" not in adj[name], f"bench_adj {name}: {adj[name].get('error')}")
        check(adj[name]["max_err"] <= 1e-6,
              f"bench_adj {name}: max_err {adj[name]['max_err']} > 1e-6")
    check(launches["adj_count"] > 0 and launches["adj_count_onehot"] > 0,
          f"bench_adj launched no K5 or no K5-lane: {launches}")
    log(f"bench_adj: {wall:.2f} s, launches {launches}")
    return launches


# ---------------------------------------------------------------- widths --

def width_masks(dev, Lk: int):
    """[3, Lk] key masks for the width phase: holes (k3_edge_masks' first
    row), a row whose first 512-key block is all padding (K3-fwd skips the
    block whole), and a row with no valid key."""
    import torch

    j = torch.arange(Lk, device=dev)
    return torch.stack([k3_edge_masks(dev, 3, Lk)[0], j >= 520,
                        torch.zeros_like(j, dtype=torch.bool)])


def check_widths(gen, dev) -> list[dict]:
    """Each kernel against its plain version at head / embedding widths
    other than the path's, in both dtypes where it has both routes: K3 fwd /
    dq / dkv at K3_WIDTHS (fp32 through autograd at L = 600 as
    check_k3_fp32, bf16 by check_k3_bf16 at Lq = 300 against Lk = 1100,
    dropout 0.5), K2 and K4 at SEGMENT_WIDTHS (check_segment_case on
    edge_segments at L = 300), K1 at K1_WIDTHS (check_k1_case on 512 rows
    against 3000 codewords and their last third). Widths that are no built
    width run padded, and every call must launch its kernel. Then the wide
    routes by check_wide_routes, each of which must launch; returns their
    rows of the kernels line (wide_times)."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    t0 = time.perf_counter()
    bf = torch.bfloat16
    for f in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv,
              fa.packed_segment_attention, fa.packed_segment_attention_nt, fused_topk_l2):
        f.launches = 0
        f.wide_launches = 0
    for Dh in K3_WIDTHS:
        kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=0.5, dropout_seed=K3_SEED)
        check_k3_fp32(gen, dev, width_masks(dev, 600), kw, Dh=Dh)
        B, H, Lq, Lk = 3, 2, 300, 1100
        q, do = (torch.randn(B, H, Lq, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        k, v = (torch.randn(B, H, Lk, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        check_k3_bf16(q, k, v, do, width_masks(dev, Lk), kw, f"width Dh={Dh}")
    for Dh in SEGMENT_WIDTHS:
        for nt in (False, True):
            check_segment_case(gen, dev, edge_segments(dev, 300), nt,
                               f"width Dh={Dh}, edge segments L=300", H=2, Dh=Dh)
    for Dk in K1_WIDTHS:
        z, cb = unit_rows(gen, dev, 512, Dk), unit_rows(gen, dev, 3000, Dk)
        for label, e in (("full", cb), ("region", vq.region_slice(cb, "graph"))):
            check_k1_case(z, e, f"width D={Dk} {label}")
    launches = {f.__name__: f.launches
                for f in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv,
                          fa.packed_segment_attention, fa.packed_segment_attention_nt,
                          fused_topk_l2)}
    check(all(n > 0 for n in launches.values()), f"width phase: a kernel never ran: {launches}")
    check(not any(wide_launches().values()),
          f"width phase: a width up to 256 took a wide route: {wide_launches()}")
    errs = check_wide_routes(gen, dev)
    ran = wide_launches()
    check(all(n > 0 for n in ran.values()), f"width phase: a wide route never ran: {ran}")
    log(f"width phase: {time.perf_counter() - t0:.2f} s, launches {launches}, wide routes "
        f"{ran}")
    width_times(gen, dev)
    return wide_times(gen, dev, errs, ran)


def width_times(gen, dev) -> None:
    """Device times of each kernel at every width of the width phase, both
    dtypes: K3 fwd / dq / dkv at [16*4, 2003, Dh] all-valid, dropout 0.5;
    K2 and K4 at [256, 12, 128, Dh] on edge_segments rows; K1 at z [4096,
    D] against 21000 codewords."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for Dh in K3_WIDTHS:
            kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=0.5, dropout_seed=K3_SEED)
            q, k, v, do = (torch.randn(16, 4, 2003, Dh, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            m = torch.ones(16, 2003, dtype=torch.bool, device=dev)
            out, lse = fa.flash_attention_fwd(q, k, v, m, **kw)
            bwd = (q, k, v, m, lse, (do.float() * out.float()).sum(-1), do)
            ms = [cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, m, **kw), 3),
                  cuda_ms(lambda: fa.flash_attention_dq(*bwd, **kw), 3),
                  cuda_ms(lambda: fa.flash_attention_dkv(*bwd, **kw), 3)]
            log(f"width times K3 {tag} [16*4, 2003, {Dh}] all-valid: fwd {ms[0]:.4f} ms, "
                f"dq {ms[1]:.4f} ms, dkv {ms[2]:.4f} ms")
            del q, k, v, do, out, lse, bwd
        seg = edge_segments(dev, 128).repeat(52, 1)[:256].contiguous()
        for Dh in SEGMENT_WIDTHS:
            q, k, v = (torch.randn(256, 12, 128, Dh, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            k2 = cuda_ms(lambda: fa.packed_segment_attention(q, k, v, seg), 5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            k4 = cuda_ms(lambda: fa.packed_segment_attention_nt(qt, kt, vt, seg), 5)
            log(f"width times K2 / K4 {tag} [256, 12, 128, {Dh}] on edge segments: K2 "
                f"{k2:.4f} ms, K4 {k4:.4f} ms")
            del q, k, v, qt, kt, vt
    for Dk in K1_WIDTHS:
        z, cb = unit_rows(gen, dev, 4096, Dk), unit_rows(gen, dev, 21000, Dk)
        log(f"width times K1 z [4096, {Dk}] x e [21000, {Dk}], k={K}: "
            f"{cuda_ms(lambda: fused_topk_l2(z, cb, k=K), 5):.4f} ms")


def check_width_witnesses(dev) -> None:
    """The smallest inputs of ROADMAP Queue 3's fixed width faults: while
    each kernel took one width, K3 on [1, 1, 1, 32] bf16 and K2 on [1, 1,
    1, 8] bf16 with seg [[1]] (one valid key: they return v) and K1 on z [1,
    16] against 5 codewords (the plain version's indices) raised, each
    launching its kernel now; until the wide routes, width 264 and K1's
    k = 9 raised: K3 and K2 on [1, 1, 1, 264] fp32 now return v and K1 at
    D = 264 and at k = 9 the plain version's indices, each by one launch of
    its wide route."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2, fused_topk_l2_reference

    g = torch.Generator(device=dev).manual_seed(K3_SEED)
    q, k, v = (torch.randn(1, 1, 1, 32, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention(q, k, v)
    check(torch.equal(out, v) and fa.flash_attention_fwd.launches == before + 1,
          f"witness: flash_attention on [1, 1, 1, 32] gave {out.flatten()[:4].tolist()}, "
          f"not v")
    q, k, v = (torch.randn(1, 1, 1, 8, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    seg = torch.ones(1, 1, dtype=torch.int32, device=dev)
    before = fa.packed_segment_attention.launches
    out = fa.packed_segment_attention(q, k, v, seg)
    check(torch.equal(out, v) and fa.packed_segment_attention.launches == before + 1,
          "witness: packed_segment_attention on [1, 1, 1, 8] did not return v")
    z, e = unit_rows(g, dev, 1, 16), unit_rows(g, dev, 5, 16)
    before = fused_topk_l2.launches
    _, idx = fused_topk_l2(z, e, k=K)
    _, want = fused_topk_l2_reference(z, e, K)
    check(torch.equal(idx, want) and fused_topk_l2.launches == before + 1,
          f"witness: K1 on z [1, 16], codebook [5, 16] gave {idx.tolist()}, want "
          f"{want.tolist()}")
    # width 264 and k = 9 (they raised until the wide routes): each launches
    # its wide route and returns the plain version's result
    before = wide_launches()
    q, k, v = (torch.randn(1, 1, 1, 264, generator=g, device=dev) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    check(torch.equal(out, v), "witness: flash_attention on [1, 1, 1, 264] did not return v")
    out = fa.packed_segment_attention(q, k, v, seg)
    check(torch.equal(out, v),
          "witness: packed_segment_attention on [1, 1, 1, 264] did not return v")
    for z, e, k_ in ((q[0, 0], unit_rows(g, dev, 5, 264), 1),
                     (unit_rows(g, dev, 1, 16), unit_rows(g, dev, 12, 16), 9)):
        _, idx = fused_topk_l2(z, e, k=k_)
        _, want = fused_topk_l2_reference(z, e, k_)
        check(torch.equal(idx, want), f"witness: K1 on z {list(z.shape)}, codebook "
              f"{list(e.shape)}, k={k_} gave {idx.tolist()}, want {want.tolist()}")
    ran = {n: c - before[n] for n, c in wide_launches().items()}
    want_ran = {"topk_l2_wide": 2, "segment_attention_wide": 1, "flash_attention_fwd_wide": 1}
    check(all(ran[n] == c for n, c in want_ran.items()),
          f"witness: wide-route launches {ran}, want {want_ran}")
    log(f"width witnesses: K3 [1, 1, 1, 32] and K2 [1, 1, 1, 8] return v, K1 z [1, 16] "
        f"against 5 codewords gives the plain version's indices; width 264 runs: K3 and "
        f"K2 on [1, 1, 1, 264] return v and K1 at D=264 (k=1) and at k=9 (D=16) give the "
        f"plain version's indices, each by its wide route ({ran})")


def wide_counters() -> dict:
    """Name in the kernels line -> the wrapper whose ``wide_launches``
    counts that wide route."""
    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    return {"topk_l2_wide": fused_topk_l2,
            "segment_attention_wide": fa.packed_segment_attention,
            "segment_attention_nt_wide": fa.packed_segment_attention_nt,
            "flash_attention_fwd_wide": fa.flash_attention_fwd,
            "flash_attention_dq_wide": fa.flash_attention_dq,
            "flash_attention_dkv_wide": fa.flash_attention_dkv}


def wide_launches() -> dict:
    return {name: f.wide_launches for name, f in wide_counters().items()}


def check_wide_routes(gen, dev) -> dict:
    """The wide routes against their plain versions by the checks of phases
    3, 4, 7 and 10, in both dtypes where the kernel has both: K3 fwd / dq /
    dkv at WIDE_WIDTHS (fp32 through autograd at L = 600, bf16 at Lq = 300
    against Lk = 1100, dropout 0.5, width_masks), K2 and K4 at WIDE_WIDTHS
    (edge_segments at L = 300), K1 at WIDE_WIDTHS with k in WIDE_K (512 rows
    against 3000 codewords and their last third), k in WIDE_K at the built
    width 64, and exact ties at D = 320, k = 16. Returns each route's
    largest error (bf16 for the attention routes, as the kernels line
    reports them)."""
    import torch

    from medtok_tpu_torch.ops import vq

    bf = torch.bfloat16
    errs = dict.fromkeys(wide_counters(), 0.0)
    for Dh in WIDE_WIDTHS:
        kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=0.5, dropout_seed=K3_SEED)
        check_k3_fp32(gen, dev, width_masks(dev, 600), kw, Dh=Dh)
        B, H, Lq, Lk = 3, 2, 300, 1100
        q, do = (torch.randn(B, H, Lq, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        k, v = (torch.randn(B, H, Lk, Dh, generator=gen, device=dev).to(bf) for _ in range(2))
        e16 = check_k3_bf16(q, k, v, do, width_masks(dev, Lk), kw, f"wide Dh={Dh}")
        for key in ("fwd", "dq", "dkv"):
            name = f"flash_attention_{key}_wide"
            errs[name] = max(errs[name], e16["out" if key == "fwd" else key])
    for Dh in WIDE_WIDTHS:
        for nt in (False, True):
            c = check_segment_case(gen, dev, edge_segments(dev, 300), nt,
                                   f"wide Dh={Dh}, edge segments L=300", H=2, Dh=Dh)
            name = "segment_attention_nt_wide" if nt else "segment_attention_wide"
            errs[name] = max(errs[name], c["err16"])
    for Dk in WIDE_WIDTHS:
        z, cb = unit_rows(gen, dev, 512, Dk), unit_rows(gen, dev, 3000, Dk)
        for k in WIDE_K:
            for label, e in (("full", cb), ("region", vq.region_slice(cb, "graph"))):
                err = check_k1_case(z, e, f"wide D={Dk} {label}", k=k)
                errs["topk_l2_wide"] = max(errs["topk_l2_wide"], err)
    z, cb = unit_rows(gen, dev, 512, D), unit_rows(gen, dev, 3000, D)
    for k in WIDE_K:
        check_k1_case(z, cb, f"wide k, D={D} full", k=k)
    check_k1_ties(unit_rows(gen, dev, 512, 320), unit_rows(gen, dev, 1500, 320), 16,
                  "K1 wide ties")
    return errs


def wide_times(gen, dev, errs: dict, ran: dict) -> list[dict]:
    """Each wide route timed at one shape beside its plain version, the
    library call for its function and its bound, as rows of the kernels
    line (``ran``: the width phase's launches of each). A bound is the
    function's, whatever the route's design: its operations at the card's
    peak for the inputs' type, as the kernels' own rows count them (K1's
    fp32 products as 3xTF32, 3 x 2 B N D operations at the TF32 peak; bf16
    attention at the bf16 peak), or its bytes, whichever is slower. K1 at z
    [4096, 320] against 21000 codewords, k = 9; K2 / K4 bf16 at [256, 4,
    128, 320] on edge_segments rows (segment_bound's work); K3 bf16 at
    [8*2, 1100, 320], all keys valid, dropout 0.5 (check_k3's work
    counts)."""
    import torch
    import torch.nn.functional as F

    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2, fused_topk_l2_reference

    def row(name, source, site, ms, plain_ms, library_ms, ops, peak, nbytes):
        ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bound:.4f} ms ({ops / 1e9:.2f} GFLOP at "
            f"{peak / 1e12:.0f} TFLOP/s: {ops_ms:.4f} ms; {nbytes / 1e6:.1f} MB: "
            f"{bytes_ms:.4f} ms); kernel {ms / bound:.2f}x the bound; "
            f"{ran[name]} launches in the width phase")
        return dict(name=name, route="cuda", source=f"medtok_tpu_torch/csrc/{source}",
                    replaces=site, launches=ran[name], max_abs_err=errs[name], ms=ms,
                    plain_ms=plain_ms, bound_ms=bound,
                    bound_by="operations" if ops_ms > bytes_ms else "bytes",
                    library_ms=library_ms)

    rows = []
    B, N, Dk, k = 4096, 21000, 320, 9
    z, cb = unit_rows(gen, dev, B, Dk), unit_rows(gen, dev, N, Dk)

    def library():
        d = (z * z).sum(1, keepdim=True) + (cb * cb).sum(1)[None] - 2.0 * (z @ cb.T)
        return torch.topk(d, k, dim=1, largest=False)

    rows.append(row("topk_l2_wide", "topk_l2.cu", "medtok_tpu/ops/vq_pallas.py:139",
                    cuda_ms(lambda: fused_topk_l2(z, cb, k=k), 5),
                    cuda_ms(lambda: fused_topk_l2_reference(z, cb, k), 3),
                    cuda_ms(library, 5), 3 * 2.0 * B * N * Dk, PEAK_TF32,
                    4.0 * (B + N) * Dk + 8.0 * B * k))
    del z, cb

    Dh, H = 320, 4
    seg = edge_segments(dev, 128).repeat(52, 1)[:256].contiguous()
    pair = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    _, ops, nbytes = segment_bound(seg, H, Dh)
    for nt in (False, True):
        _, fn, plain = segment_fns(nt)
        shape = (256, 128, H, Dh) if nt else (256, H, 128, Dh)
        q, k_, v = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        views = heads_first(q, k_, v) if nt else (q, k_, v)
        rows.append(row(f"segment_attention{'_nt' if nt else ''}_wide",
                        "segment_attention.cu",
                        f"medtok_tpu/ops/flash_attention.py:{654 if nt else 740}",
                        cuda_ms(lambda: fn(q, k_, v, seg), 5),
                        cuda_ms(lambda: plain(q, k_, v, seg), 3),
                        cuda_ms(lambda: F.scaled_dot_product_attention(
                            *views, attn_mask=pair), 5), ops, PEAK_BF16, nbytes))

    Bf, L, rate = 8, 1100, 0.5
    kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=rate, dropout_seed=K3_SEED)
    q, k_, v, do = (torch.randn(Bf, 2, L, Dh, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(4))
    m = torch.ones(Bf, L, dtype=torch.bool, device=dev)
    out, lse = fa.flash_attention_fwd(q, k_, v, m, **kw)
    bwd = (q, k_, v, m, lse, (do.float() * out.float()).sum(-1), do)
    leaves = [t.clone().requires_grad_() for t in (q, k_, v)]
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k_, v, dropout_p=rate), 3)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
        return torch.autograd.grad(o, leaves, do)

    sdpa_bwd = cuda_ms(sdpa_fwd_bwd, 3) - sdpa_fwd
    pairs = 2.0 * L * Bf * L
    t_row, vec, mask_b = Bf * 2 * L * Dh * 2, Bf * 2 * L * 4, Bf * L
    for key, fn, plain, args, ops, nbytes, lib in (
            ("fwd", fa.flash_attention_fwd, fa.flash_attention_reference, bwd[:4],
             4 * Dh * pairs, 4 * t_row + vec + mask_b, sdpa_fwd),
            ("dq", fa.flash_attention_dq, fa.flash_attention_dq_reference, bwd,
             6 * Dh * pairs, 5 * t_row + 2 * vec + mask_b, sdpa_bwd),
            ("dkv", fa.flash_attention_dkv, fa.flash_attention_dkv_reference, bwd,
             8 * Dh * pairs, 6 * t_row + 2 * vec + mask_b, sdpa_bwd)):
        site = {"fwd": 249, "dq": 311, "dkv": 334}[key]
        rows.append(row(f"flash_attention_{key}_wide", "flash_attention.cu",
                        f"medtok_tpu/ops/flash_attention.py:{site}",
                        cuda_ms(lambda: fn(*args, **kw), 3),
                        cuda_ms(lambda: plain(*args, **kw), 2), lib, ops, PEAK_BF16,
                        nbytes))
    return rows


def check_ehr_heads(table, ehr: dict, dev, n: int = 32) -> None:
    """EHRTrainer(EHRTrainConfig(num_heads=2)) (head width 32) trains two
    steps on n samples of an eval batch with K3: 4 launches of each K3
    kernel a step, finite losses."""
    import numpy as np
    import torch

    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer
    from medtok_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(EHRTrainConfig(), num_heads=2)
    trainer = EHRTrainer(cfg, table, 2, device=dev)
    check(trainer.use_flash, "EHR num_heads=2: K3 was not picked on the card")
    first = ehr["eval"][0]
    batch = type(first)(*(x[:n] for x in first))
    for f in (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv):
        f.launches = 0
    losses = [float(trainer.train_step(batch)[0]) for _ in range(2)]
    torch.cuda.synchronize()
    counts = k3_counts()
    want = dict.fromkeys(("fwd", "dq", "dkv"), 2 * cfg.num_layers)
    check(counts == want, f"EHR num_heads=2: K3 launches {counts} != {want}")
    check(all(map(np.isfinite, losses)), f"EHR num_heads=2: losses {losses}")
    log(f"EHR num_heads=2 (head width {cfg.input_dim // cfg.num_heads}): two train "
        f"steps on {n} samples, losses {losses}, K3 launches {counts}")


def check_small_export(dataset, dev, gen) -> None:
    """The verify recipe's widths (text hidden 32 / 4 heads: K2 at head
    width 8; codebook 90 x 16: K1 at width 16; graph 8/16/16): a small fp32
    export with the kernels on the card against the plain versions on the
    CPU by check_reference's tie-gap rule, K1 and K2 launched."""
    from medtok_tpu_torch.config import (
        GraphEncoderConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
    )
    from medtok_tpu_torch.models.layers import init_random_
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    cfg = ModelConfig(
        text=TextEncoderConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
        graph=GraphEncoderConfig(in_channels=8, hidden_channels=16, out_channels=16),
        quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16))
    model = init_random_(MultimodalTokenizer(cfg, device=dev), gen).eval()
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    check_reference(model, dataset, dev, label="verify-recipe widths, fp32")
    launches = {"topk_l2": fused_topk_l2.launches,
                "segment_attention": packed_segment_attention.launches}
    check(all(n > 0 for n in launches.values()),
          f"verify-recipe widths: a kernel never ran on the card: {launches}")
    log(f"verify-recipe widths export: launches {launches}")


# -------------------------------------------------------------- training --

TRAIN_BATCH = 1024
TRAIN_TIMED_STEPS = 5
TRAIN_SWEEPS = 6        # K1 sweeps a step: shared text / graph, 4 specific
K1_KERNELS = ("tf32_split_kernel", "topk_tf32_kernel", "topk_merge_kernel")


def train_breakdown(prof) -> tuple[dict, dict]:
    """Device time of one profiled train step by part, as {"forward": {part:
    Counter(kernel name -> us)}, "backward": {...}}. Each kernel is matched
    to the runtime call that launched it (one CUDA correlation id) and so to
    a place on the host timeline: inside a train.* range, it is that part's
    forward (the optimizer range is clip + Adam + EMA); inside an autograd
    node's evaluation, it is the backward of the part whose forward op
    created the node (matched by sequence number), and a launch between
    nodes (the engine's sums of gradients that meet at one tensor) is
    "backward / sums"; anything else (the batch's copies) is "outside".
    Also the device ms of K1, K2, all kernels, and copies."""
    import bisect
    import collections
    import re

    import torch

    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    host = [e for e in events if e.device_type == cpu]
    runtime = {e.id: e for e in host if re.match(r"cu(da)?[A-Z]", e.name)}
    # device events that are kernels or copies, not the device-side spans
    # of record_function ranges (train.*, gcn_norm_adj)
    kernels = [e for e in events if e.device_type == gpu
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("train.") and e.name != "gcn_norm_adj"]

    def intervals(evs):
        evs = sorted(evs, key=lambda e: e.time_range.start)
        return [e.time_range.start for e in evs], evs

    def containing(table, t):
        starts, evs = table
        k = bisect.bisect_right(starts, t) - 1
        return evs[k] if k >= 0 and t <= evs[k].time_range.end else None

    ranges = intervals(e for e in host
                       if e.name.startswith("train.") and e.name != "train.backward")
    nodes = intervals(e for e in host
                      if e.name.startswith("autograd::engine::evaluate_function"))
    backward = intervals(e for e in host if e.name == "train.backward")
    seq_part = {}
    for e in host:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            r = containing(ranges, e.time_range.start)
            if r is not None:
                seq_part.setdefault(e.sequence_nr, r.name[len("train."):])
    parts = {"forward": collections.defaultdict(collections.Counter),
             "backward": collections.defaultdict(collections.Counter)}
    for k in kernels:
        launch = runtime.get(k.id)
        t = launch.time_range.start if launch is not None else None
        r = containing(ranges, t) if t is not None else None
        node = containing(nodes, t) if t is not None else None
        if r is not None:
            side, part = "forward", r.name[len("train."):]
        elif node is not None:
            side, part = "backward", seq_part.get(node.sequence_nr, "unmatched node")
        elif t is not None and containing(backward, t) is not None:
            side, part = "backward", "sums"
        else:
            side, part = "forward", "outside" if launch is not None else "no launch found"
        parts[side][part][k.name] += k.time_range.end - k.time_range.start
    totals = {
        "K1": sum(e.device_time_total for e in kernels
                  if any(n in e.name for n in K1_KERNELS)) / 1e3,
        "K2": sum(e.device_time_total for e in kernels if "segment_attention" in e.name) / 1e3,
        "copies": sum(e.device_time_total for e in kernels
                      if e.name.startswith("Memcpy")) / 1e3,
        "all": sum(e.device_time_total for e in kernels) / 1e3,
    }
    return parts, totals


def train_batches(dataset, cfg, n: int) -> tuple[list, list]:
    """The first n batches of epoch_batches (edge dropout on) and the host
    ms each took to collate."""
    from medtok_tpu_torch.data.dataset import epoch_batches

    it = epoch_batches(dataset, batch_size=cfg.train.global_batch_size,
                       seed=cfg.train.global_seed)
    batches, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        batches.append(next(it))
        ms.append(1e3 * (time.perf_counter() - t0))
    return batches, ms


def check_train_determinism(trainer, state, batch, cfg) -> None:
    """Two forward + backward passes from one state and one generator state
    (the usage FIFO put back in between) give bitwise equal losses, usage
    FIFOs and gradients."""
    import torch

    from medtok_tpu_torch.train.trainer import _loss_fn, trainable_parameters

    model = trainer.model.train()
    q = model.quantize
    params = [p for _, p in trainable_parameters(model)]
    tb, packed = batch.to(trainer.device), trainer.pack(batch).to(trainer.device)
    usage = (q.codebook_used.clone(), q.usage_counts.clone())
    gen_state = state.generator.get_state()
    runs = []
    for _ in range(2):
        q.codebook_used.copy_(usage[0])
        q.usage_counts.copy_(usage[1])
        state.generator.set_state(gen_state)
        for p in params:
            p.grad = None
        loss, _ = _loss_fn(model, tb, cfg, packed=packed, generator=state.generator)
        loss.backward()
        runs.append([loss.detach(), q.codebook_used.clone(), q.usage_counts.clone()]
                    + [p.grad.clone() for p in params])
    for p in params:
        p.grad = None
    q.codebook_used.copy_(usage[0])
    q.usage_counts.copy_(usage[1])
    names = ["loss", "codebook_used", "usage_counts"] + [
        n for n, _ in trainable_parameters(model)]
    differ = [n for n, a, b in zip(names, *runs) if not torch.equal(a, b)]
    check(not differ, f"training: two passes from one state differ in {differ}")
    log(f"training: two forward + backward passes from one state and one generator "
        f"state: loss, usage FIFO and all {len(params)} gradients bitwise equal")


def run_training(dataset, dev, gen) -> dict:
    """Trainer.fit at ModelConfig() width, packed text, batch 1024, over
    epoch_batches of the export's dataset: a warm-up step that records K1's
    inputs, TRAIN_TIMED_STEPS steps over batches collated in advance (the
    step alone), TRAIN_TIMED_STEPS steps of fit drawing from epoch_batches
    (end to end), each with K1 / K2 counted, a profiled step, the checks,
    then K1 and K2 against their plain versions at the training shapes.
    Returns the end-to-end run's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from medtok_tpu_torch.config import MedTokConfig, ModelConfig, TrainConfig
    from medtok_tpu_torch.data.dataset import epoch_batches
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.train.trainer import Trainer, trainable_parameters

    cfg = MedTokConfig(model=ModelConfig(), data=dataset.cfg,
                       train=TrainConfig(packed_text=True, global_batch_size=TRAIN_BATCH))
    T = TRAIN_TIMED_STEPS
    batches, collate_ms = train_batches(dataset, cfg, T + 3)
    logged = []
    trainer = Trainer(cfg, device=dev, log_fn=lambda step, m: logged.append(m))
    model = trainer.model
    state = trainer.init_state()
    pack_ms = []
    for b in batches:
        t0 = time.perf_counter()
        trainer.pack(b)
        pack_ms.append(1e3 * (time.perf_counter() - t0))
    bert0 = [p.detach().clone() for p in model.text_model.parameters()]
    train0 = {n: p.detach().clone() for n, p in trainable_parameters(model)}
    n_train = sum(p.numel() for p in train0.values())
    n_bert = sum(p.numel() for p in bert0)
    log(f"training: ModelConfig() width, {n_train / 1e6:.3f} M trainable fp32 "
        f"parameters, frozen BERT {n_bert / 1e6:.1f} M ({cfg.model.compute_dtype}); "
        f"batch {TRAIN_BATCH}, packed rows of {cfg.train.packed_row_len}, "
        f"{trainer.pack_rows} rows a batch (1.3 x the first batch's tokens)")
    for i, b in enumerate(batches):
        tokens = int(np.asarray(b.attention_mask).sum())
        log(f"  batch {i}: (Lt, Ln, Epg) = ({b.input_ids.shape[1]}, {b.node_ids.shape[1]}, "
            f"{b.edge_src.shape[0] // TRAIN_BATCH}), {tokens} text tokens, "
            f"{int(b.edge_weight_aug.sum())} of {int(b.edge_weight.sum())} edges kept "
            f"in the augmented view")

    # the warm-up step records K1's inputs as training gives them (the
    # region sweeps read their rows in place, as views of the codebook)
    k1_inputs = []
    distance_topk = vq.distance_topk

    def recorded(z_n, e_n, k, **kw):
        k1_inputs.append((z_n.detach(), e_n.detach(), k))
        return distance_topk(z_n, e_n, k, **kw)

    vq.distance_topk = recorded
    try:
        state = trainer.fit(state, batches[:1])                # warm-up
    finally:
        vq.distance_topk = distance_topk
    n_layers = cfg.model.text.num_layers
    want = {"topk_l2": TRAIN_SWEEPS * T, "segment_attention": n_layers * T}

    def timed_fit(state, batches, **kw):
        fused_topk_l2.launches = 0
        packed_segment_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.fit(state, batches, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"topk_l2": fused_topk_l2.launches,
                    "segment_attention": packed_segment_attention.launches}
        check(launches == want, f"training: launches {launches} != {want} "
              f"({TRAIN_SWEEPS} K1 and {n_layers} K2 a step)")
        return state, wall, launches

    # the step alone, over batches collated in advance (pack + copies + step)
    torch.cuda.reset_peak_memory_stats()
    state, step_wall, _ = timed_fit(state, batches[1:1 + T])
    peak = torch.cuda.max_memory_allocated()
    # end to end, as a user runs it: Trainer.fit drawing from epoch_batches,
    # the collate with its edge dropout inside the clock
    epoch = epoch_batches(dataset, batch_size=TRAIN_BATCH, seed=cfg.train.global_seed,
                          epoch=1)
    state, wall, launches = timed_fit(state, epoch, max_steps=state.step + T)
    check(state.step == 1 + 2 * T and len(logged) == 1 + 2 * T,
          "training: steps not taken")
    for m in logged:
        check(all(np.isfinite(v) for v in m.values()), f"training: non-finite metric {m}")
        for key in ("codebook_usage_shared", "codebook_usage_text", "codebook_usage_graph"):
            check(0.0 < m[key] <= 1.0, f"training: {key} = {m[key]} outside (0, 1]")
    log(f"training end to end: Trainer.fit over epoch_batches, {T} steps in {wall:.3f} s: "
        f"{1e3 * wall / T:.3f} ms/step, {TRAIN_BATCH * T / wall:.1f} codes/s (collate with "
        f"edge dropout + pack + copies + step); launches {launches}")
    log(f"training step alone: {T} steps over batches collated in advance in "
        f"{step_wall:.3f} s: {1e3 * step_wall / T:.3f} ms/step, "
        f"{TRAIN_BATCH * T / step_wall:.1f} codes/s (pack + copies + step); "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"training: host batch build {np.mean(collate_ms):.1f} ms collate (edge dropout "
        f"included) + {np.mean(pack_ms):.1f} ms packing per batch of {TRAIN_BATCH}")
    log("training: losses " + ", ".join(f"{m['loss']:.4f}" for m in logged)
        + "; usage shared / text / graph "
        + f"{logged[-1]['codebook_usage_shared']:.4f} / "
        + f"{logged[-1]['codebook_usage_text']:.4f} / {logged[-1]['codebook_usage_graph']:.4f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = trainer.fit(state, batches[1 + T:2 + T])
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    parts, totals = train_breakdown(prof)
    log(f"profile: one train step {prof_wall:.3f} ms wall; device kernels "
        f"{totals['all']:.3f} ms ({100 * totals['all'] / prof_wall:.1f}% of wall), "
        f"copies {totals['copies']:.3f} ms; K1 {totals['K1']:.3f} ms, K2 "
        f"{totals['K2']:.3f} ms")
    for name in sorted(set(parts["forward"]) | set(parts["backward"])):
        fk, bk = parts["forward"][name], parts["backward"][name]
        f, b = sum(fk.values()) / 1e3, sum(bk.values()) / 1e3
        log(f"  {name:15s} forward {f:9.3f} ms  backward {b:9.3f} ms  "
            f"({100 * (f + b) / max(totals['all'], 1e-9):.1f}% of the device time)")
        for side, counter in (("fwd", fk), ("bwd", bk)):
            for kname, us in counter.most_common(3):
                log(f"      {side} {us / 1e3:8.3f} ms  {kname[:90]}")
    on_gpu = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.key_averages() if e.device_type == on_gpu
              and not e.key.startswith("train.") and e.key != "gcn_norm_adj"]
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} {e.key[:90]}")

    check_train_determinism(trainer, state, batches[-1], cfg)
    for p, p0 in zip(model.text_model.parameters(), bert0):
        check(torch.equal(p, p0), "training: a frozen BERT parameter changed")
    still = [n for n, p in trainable_parameters(model) if torch.equal(p, train0[n])]
    check(not still, f"training: parameters that did not move: {still}")
    log(f"training: after {state.step} steps the BERT is bit for bit where it "
        f"started and all {len(train0)} trainable tensors moved")

    # the kernels against their plain versions at the shapes training gives
    # them: K1's six sweeps of the warm-up step, K2 on the training packing
    check(len(k1_inputs) == TRAIN_SWEEPS, f"training: {len(k1_inputs)} K1 sweeps recorded")
    for i, (z, e, k) in enumerate(k1_inputs):
        check_k1_case(z, e, f"training sweep {i}", k=k)
    seg = trainer.pack(batches[0]).to(dev).seg_ids
    check_segment_case(gen, dev, seg, False, "training packing",
                       H=cfg.model.text.num_heads,
                       Dh=cfg.model.text.hidden_size // cfg.model.text.num_heads)
    check_train_resume(trainer, state, cfg, batches[1:3])
    return launches


def check_train_resume(trainer, state, cfg, batches) -> dict:
    """One checkpoint of the live state (the EMA switched on first, so that
    it is saved too), restored into a fresh Trainer; two more steps from
    each on the same batches must agree bit for bit: parameters, usage FIFO
    (the buffers), Adam's count and moments, the EMA and the dropout
    generator. Logs and returns the save and restore times and the file's
    size."""
    import tempfile

    import torch

    from medtok_tpu_torch.train.trainer import Trainer, create_train_state, trainable_parameters
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager

    ema_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema=True))
    state.ema_params = [p.detach().clone() for _, p in trainable_parameters(state.model)]
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, max_to_keep=1, config=ema_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(state, pack_rows=trainer.pack_rows)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        fresh = Trainer(ema_cfg, device=trainer.device)
        restored = create_train_state(ema_cfg, fresh.model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, fresh.pack_rows = mgr.restore(restored)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(restored.step == state.step and fresh.pack_rows == trainer.pack_rows,
          "training resume: the restored step or row budget differs")
    runs = []
    for tr, st in ((trainer, state), (fresh, restored)):
        st = tr.fit(st, batches)
        m = st.model
        runs.append({"step": torch.tensor(st.step), "count": torch.tensor(st.opt_state.count),
                     **{f"param {n}": t for n, t in m.state_dict().items()},
                     **{f"buffer {n}": t for n, t in m.named_buffers()},
                     **{f"mu {i}": t for i, t in enumerate(st.opt_state.mu)},
                     **{f"nu {i}": t for i, t in enumerate(st.opt_state.nu)},
                     **{f"ema {i}": t for i, t in enumerate(st.ema_params)},
                     "generator": st.generator.get_state()})
    live, again = runs
    differ = [n for n in live if not torch.equal(live[n], again[n])]
    check(not differ, f"training resume: {len(differ)} tensors differ after "
          f"{len(batches)} steps from the restored state: {differ[:8]}")
    log(f"training resume: checkpoint at step {state.step - len(batches)} saved in "
        f"{save_s:.3f} s ({size} bytes), restored into a fresh Trainer in {restore_s:.3f} s; "
        f"{len(batches)} more steps from each bitwise equal: {len(live)} tensors (parameters, "
        f"usage FIFO, Adam count and moments, EMA, generator)")
    return dict(save_s=save_s, restore_s=restore_s, bytes=size)


def check_train_reference(dataset, dev, n_codes: int = 64) -> None:
    """One packed fp32 train step at the verify recipe's widths (text 32 / 4
    heads: K2 at head width 8; codebook 90 x 16: K1 at width 16; graph
    8 / 16 / 16; cross-attention dropout 0), kernels on the card against
    the plain versions on the CPU from one state: token rows by phase 5's
    tie-gap rule, the 22 loss terms within 1e-5, each gradient within 1e-4
    of its largest (the key bias, whose exact gradient is 0, within 1e-5 of
    the key weight's)."""
    import numpy as np
    import torch

    from medtok_tpu_torch.config import (
        GraphEncoderConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
    )
    from medtok_tpu_torch.data.packing import pack_code_batch
    from medtok_tpu_torch.models.layers import init_random_
    from medtok_tpu_torch.models.tokenizer_model import PATH_ORDER, MultimodalTokenizer
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.train.losses import assemble_losses
    from medtok_tpu_torch.train.trainer import packed_rows_budget, trainable_parameters

    cfg = ModelConfig(
        text=TextEncoderConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
        graph=GraphEncoderConfig(in_channels=8, hidden_channels=16, out_channels=16),
        quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16,
                                  cross_attn_dropout=0.0),
        compute_dtype="float32")
    batch = dataset.make_batch(list(range(n_codes)), aug_seed=1)
    am = np.asarray(batch.attention_mask)
    packed = pack_code_batch(np.asarray(batch.input_ids), am,
                             num_rows=packed_rows_budget(am, 128), row_len=128)
    cpu = torch.device("cpu")
    ref = init_random_(MultimodalTokenizer(cfg, param_dtype=torch.float32),
                       torch.Generator().manual_seed(3))
    card = MultimodalTokenizer(cfg, param_dtype=torch.float32, device=dev)
    card.load_state_dict(ref.state_dict())
    res = []
    for model, where in ((card, dev), (ref, cpu)):
        fused_topk_l2.launches = 0
        packed_segment_attention.launches = 0
        out = model.train().forward_train(batch.to(where), packed=packed.to(where))
        total, metrics = assemble_losses(out)
        total.backward()
        toks = torch.stack([out[f"{p}_tokens"] for p in PATH_ORDER], 1).cpu().numpy()
        w = torch.stack([out[f"{p}_tokens_weights"] for p in PATH_ORDER], 1)
        res.append(dict(tok=toks, w=w.detach().cpu().numpy(),
                        metrics={k: float(v.detach()) for k, v in metrics.items()},
                        grads={n: p.grad.cpu().numpy() for n, p in trainable_parameters(model)},
                        launches={"topk_l2": fused_topk_l2.launches,
                                  "segment_attention": packed_segment_attention.launches}))
    launches = res[0]["launches"]
    check(launches == {"topk_l2": TRAIN_SWEEPS, "segment_attention": 2},
          f"training reference: launches {launches}")
    got, want = res
    gaps = tie_gaps(got["tok"], got["w"], want["tok"], want["w"])
    max_gap = float(gaps.max(initial=0.0))
    check(max_gap <= 1e-5, f"training reference: token rows differ beyond a tie ({gaps})")
    metric_err = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                     for k, v in want["metrics"].items())
    check(metric_err <= 1e-5, f"training reference: loss terms off by {metric_err:.3e}")
    grad_err = 0.0
    for name, g in want["grads"].items():
        if name.endswith("k_proj.bias"):
            scale = np.abs(want["grads"][name.replace("bias", "weight")]).max()
            check(max(np.abs(g).max(), np.abs(got["grads"][name]).max()) <= 1e-5 * scale,
                  f"training reference: {name} is not noise around 0")
            continue
        grad_err = max(grad_err, float(np.abs(got["grads"][name] - g).max() / np.abs(g).max()))
    check(grad_err <= 1e-4, f"training reference: gradients off by {grad_err:.3e} of the largest")
    log(f"training reference ({n_codes} codes, fp32, kernels on the card vs plain on the "
        f"CPU): {int((got['tok'] != want['tok']).any(-1).sum())} token rows differ (max "
        f"tie gap {max_gap:.3e}), loss terms within {metric_err:.3e}, gradients within "
        f"{grad_err:.3e} of the largest; launches {launches}")


# ------------------------------------------------------------------ CLIs --

CLI_CODES = 4096
CLI_KG_EDGES = 1_000_000  # phase 5 has 4 M; fewer keep the four CSV reads short


def run_clis(seed: int, dev) -> dict:
    """Phase 16: the train and export CLIs at ModelConfig() width, on files
    they read as a user's: a synthetic kg.csv of 130,000 nodes and
    CLI_KG_EDGES edges, a CLI_CODES-code codes.jsonl and the vocab.txt.
    cli.train to step 2 with a checkpoint every step (two kept), then
    --workdir to step 4 (resumed from 2; 0000003.pt and 0000004.pt left),
    then cli.export --workdir, each with K1 and K2 launched; then
    MedTok.from_checkpoint on the first 256 codes held to the export's rows
    by phase 5's tie-gap rule. fp32 compute (--mixed-precision none): the
    API's unpacked text path and the export's packed one round differently
    in bf16 (phase 15 trains in bf16). Returns the runs' wall times and
    launches."""
    import json
    import tempfile

    import numpy as np
    import torch

    from medtok_tpu_torch.api import MedTok
    from medtok_tpu_torch.cli import export as export_cli
    from medtok_tpu_torch.cli import train as train_cli
    from medtok_tpu_torch.data.dataset import MedCodeDataset, write_jsonl
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.synthetic import (
        MEDICAL_WORDS,
        SYLLABLES,
        synthetic_kg,
        synthetic_vocab_columns,
    )
    from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager

    rng = np.random.default_rng(seed + 16)
    runs = {}

    def run(label, fn, argv):
        fused_topk_l2.launches = 0
        packed_segment_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        launches = {"topk_l2": fused_topk_l2.launches,
                    "segment_attention": packed_segment_attention.launches}
        runs[label] = dict(wall_s=time.perf_counter() - t0, launches=launches)
        check(all(n > 0 for n in launches.values()), f"CLI {label}: a kernel never ran: "
              f"{launches}")
        log(f"CLI {label}: {runs[label]['wall_s']:.3f} s wall, launches {launches}")
        return out

    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        kg = synthetic_kg(rng, num_nodes=130_000, num_edges=CLI_KG_EDGES, local_frac=0.7,
                          local_window=64)
        names = np.array(sorted(kg.rel_vocab, key=kg.rel_vocab.get))
        with open(root / "kg.csv", "w") as f:
            f.write("x_index,y_index,display_relation\n")
            f.writelines(map("{},{},{}\n".format, kg.edge_src.tolist(), kg.edge_dst.tolist(),
                             names[kg.rel_index].tolist()))
        write_jsonl(synthetic_vocab_columns(rng, num_codes=CLI_CODES, num_kg_nodes=130_000,
                                            heavy_tail=True), root / "codes.jsonl")
        vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
        for s in SYLLABLES:
            vocab.setdefault("##" + s, len(vocab))
        (root / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
        log(f"CLI data: kg.csv of 130000 nodes and {CLI_KG_EDGES} edges "
            f"({(root / 'kg.csv').stat().st_size} bytes), codes.jsonl of {CLI_CODES} codes, "
            f"vocab.txt of {len(vocab)} tokens, written in {time.perf_counter() - t0:.2f} s")

        argv = ["--kg-path", str(root / "kg.csv"),
                "--med-codes-pkg-map-path", str(root / "codes.jsonl"),
                "--text-vocab", str(root / "vocab.txt"), "--results-dir", str(root / "results"),
                "--global-batch-size", "1024", "--ckpt-every", "1", "--max-checkpoints", "2",
                "--epochs", "2", "--mixed-precision", "none"]
        workdir = run("train", train_cli.main, [*argv, "--max-steps", "2"])
        mgr = CheckpointManager(workdir)
        check(mgr.steps() == [1, 2], f"CLI train: checkpoints {mgr.steps()}, want [1, 2]")
        size = mgr.path(2).stat().st_size
        run("resume", train_cli.main, [*argv, "--workdir", str(workdir), "--max-steps", "4"])
        files = sorted(p.name for p in mgr.ckpt_dir.iterdir())
        check(files == ["0000003.pt", "0000004.pt"], f"CLI resume: checkpoints {files}")
        check("Resumed from the checkpoint at step 2" in (workdir / "log.txt").read_text(),
              "CLI resume: the run did not resume from step 2")
        metrics = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
        check([m["step"] for m in metrics] == [1, 2, 3, 4] and
              all(np.isfinite(m["loss"]) for m in metrics),
              f"CLI train: metrics {[(m['step'], m['loss']) for m in metrics]}")
        for label in ("train", "resume"):
            want = {"topk_l2": 2 * TRAIN_SWEEPS, "segment_attention": 2 * 12}
            check(runs[label]["launches"] == want,
                  f"CLI {label}: launches {runs[label]['launches']} != {want}")
        arrays = run("export", export_cli.main, ["--workdir", str(workdir)])
        check(arrays["embeddings_all"].shape == (CLI_CODES, 4 * D)
              and np.isfinite(arrays["embeddings_all"]).all(),
              f"CLI export: embeddings_all {arrays['embeddings_all'].shape}")

        cfg = CheckpointManager.load_config(workdir)
        dataset = MedCodeDataset.from_path(
            KnowledgeGraph.from_csv(cfg.data.kg_path), cfg.data.med_codes_pkg_map_path,
            WordPieceTokenizer.from_vocab_file(cfg.data.text_vocab_path), cfg=cfg.data)
        t0 = time.perf_counter()
        out = MedTok.from_checkpoint(workdir, dataset, device=dev).tokenize_batch(
            dataset.med_codes[:256])
        runs["api"] = dict(wall_s=time.perf_counter() - t0)
        gaps = tie_gaps(out.tokens, out.weights, arrays["tokens_all"][:256],
                        arrays["weights_all"][:256])
        max_gap = float(gaps.max(initial=0.0))
        check(max_gap <= 1e-5, f"CLI: MedTok.from_checkpoint differs from the export beyond "
              f"a tie (gaps {gaps.tolist()})")
        differ = int((out.tokens != arrays["tokens_all"][:256]).any(-1).sum())
        log(f"CLI: losses {[round(m['loss'], 4) for m in metrics]}; a checkpoint is {size} "
            f"bytes; MedTok.from_checkpoint on 256 codes against the export: {differ} of "
            f"1024 token rows differ, max tie gap {max_gap:.3e}; walls "
            + ", ".join(f"{k} {v['wall_s']:.3f} s" for k, v in runs.items())
            + f" (the API: reading the data, the checkpoint and 256 codes); the phase "
            f"{time.perf_counter() - phase_t0:.3f} s")
    return dict(runs=runs, checkpoint_bytes=size)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--codes", type=int, default=16384)
    args = p.parse_args(argv)

    repo = Path(__file__).resolve().parent
    if not (repo / "medtok_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no medtok_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), {kind}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    from medtok_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill")) \
                or line.startswith("=="):
            log(f"  {line.strip()}")

    check_width_witnesses(dev)
    wide = check_widths(gen, dev)
    k1 = check_k1(gen, dev)

    t0 = time.perf_counter()
    dataset = build_dataset(args.seed, args.codes)
    dataset.warm_cache()
    log(f"data: {len(dataset)} codes, KG {dataset.kg.num_nodes} nodes / "
        f"{len(dataset.kg.edge_src)} edges, built in {time.perf_counter() - t0:.2f} s")

    packings = {"export packing": packed_segments(dataset, dev, 1.0),
                "80% packing": packed_segments(dataset, dev, 0.8)}
    check(bool((packings["80% packing"] == 0).all(dim=1).any()),
          "the 80% packing has no all-padding row")
    k2 = check_segment_kernel(gen, dev, False, packings)
    k4 = check_segment_kernel(gen, dev, True, packings)
    k5 = check_k5(gen, dev)

    from medtok_tpu_torch.config import MedTokConfig, ModelConfig
    from medtok_tpu_torch.models.layers import init_random_
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    cfg = MedTokConfig(model=ModelConfig(), data=dataset.cfg)
    model = init_random_(MultimodalTokenizer(cfg.model, device=dev), gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: ModelConfig() {n_params / 1e6:.1f} M parameters, {cfg.model.compute_dtype}")

    launches, arrays = run_main_path(model, dataset, dev)
    profile_main_path(model, dataset, dev, arrays)
    check_reference(model, dataset, dev)
    serve_requests(cfg, model, dataset, dev)
    del model

    # the export's embeddings_all is the EHR model's frozen code table
    table = arrays["embeddings_all"]
    ehr = build_ehr_data(args.seed, table.shape[0], batch=256)
    k3 = check_k3(gen, dev, key_mask_of(ehr["val"][0], dev))
    k3_launches, trainer = run_ehr(table, ehr, dev)
    check_ehr_reference(trainer, ehr, dev)
    del trainer
    check_ehr_heads(table, ehr, dev)
    check_small_export(dataset, dev, gen)
    slice3 = run_slice3()
    train_launches = run_training(dataset, dev, gen)
    check_train_reference(dataset, dev)
    log(f"training launches: {train_launches}")
    run_clis(args.seed, dev)

    k1["launches"] = launches["topk_l2"]
    k2["launches"] = launches["segment_attention"]
    for row, key in zip(k3, ("fwd", "dq", "dkv")):
        row["launches"] = k3_launches[key]
    for row in (k4, *k5):
        row["launches"] = slice3[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{key: k[key] for key in keys}
                                for k in (k1, k2, *k3, k4, *k5, *wide)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
