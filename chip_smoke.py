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
     heavy-tail vocabulary on the native route (C++ WordPiece and graph
     packer, compact batches in pinned pooled buffers copied asynchronously
     and fenced, unpacked on the card), counting kernel launches and logging
     the pools and host counters; export it again on the numpy route
     (native=False), held to the native one by the tie-gap rule; hold a
     small fp32 export with kernels against the plain versions on the CPU;
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
     257, 320, 512 and 1000, K1 at those D with k = 9, 16, 17, 64, 500
     and N, the same k at D = 64, and cases of exact ties at D = 320, k =
     16 (the register lists) and 63, 64, 501, 4097 (the radix select above
     k 16; odd k splits a pair at the k-th place); above k 16 also z rows
     equal to codewords, rows whose keys stay in device memory (60,000
     codewords) and the selection alone (select_smallest) on signed zeros,
     subnormals, ties and NaN bit for bit the CPU's stable sort; each wide
     route's launches counted (K1's radix select apart) and each timed
     beside its plain version, the library call and its bound (K1 at k 9
     and at k 64, held to the plain version there first: two chunks of
     3,195 rows);
 14. the model-level witnesses: EHRTrainer(EHRTrainConfig(num_heads=2))
     (head width 32) trains two steps on the card with 4 launches of each
     K3 kernel a step; the flags that reach the wide routes:
     EHRTrainer at input_dim = output_dim = 640, 2 heads (head width 320)
     trains two steps, 4 launches of each K3 wide kernel a step, and a
     packed export of 256 codes with the text encoder at 2 heads of the 768
     width (head width 384) and the graph output and codebook 320 wide
     launches K2's wide kernel 12 times and K1's wide route once a sweep
     (k = 5), finite outputs, each kernel then held to its plain version
     on the first inputs the path gave it (K3 by phase 7's bf16 rules with
     two backward passes bitwise equal, K2 by phase 4's, K1 by phase 3's);
     K3's wide route by the same rules at [8*2, 1100, 320] (every key
     valid) and at [2*2, 4096, 320] against 4,096 keys (one batch row every
     key valid, one a prefix of 2,500), the shares of out, dq, dk and dv
     that differ at 1100, 2003 and 4096 queries logged side by side;
     and an fp32 export at the verify recipe's widths
     (text hidden 32 / 4 heads, codebook 90 x 16) on the card is held to
     the plain versions on the CPU by phase 5's tie-gap rule;
 15. train the tokenizer at ModelConfig() width through Trainer.fit with
     TrainConfig(packed_text=True, global_batch_size=1024) over
     epoch_batches of phase 5's dataset (edge dropout on): a warm-up step,
     5 timed steps over batches built in advance (the step alone: ms/step,
     peak memory), 5 timed steps of fit drawing from epoch_batches (end to
     end: codes/s with the native route's batch build inside the clock),
     each with 6 K1 and 12 K2 launches a step, the host batch build timed
     apart on both routes (their batches equal graph by graph, the dropout
     bits the routes' own), one profiled step split by
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
     codes held to the export's rows by phase 5's tie-gap rule;
 17. medical QA (no kernel on this path: attention is plain torch ops) at
     LLAMA31_8B width in bf16 with random weights from the seed (LoRA
     r = 16 on q / v, remat) and phase 5's embeddings_all plus 100 miss
     rows: 1 warm-up and 3 timed QAFinetuner steps at B = 16, cutoff 256,
     total_len 512 on medmcqa_200.json rows (ms/step, tokens/s, peak
     memory, losses; fail on a non-finite loss, a changed base weight or
     a trainable tensor that did not move); generate at B = 16, 32 new
     tokens: greedy (prefill ms and decode ms/token from the streaming
     route), greedy with an eos every row reaches (the early exit and the
     eos fill), sampling at temperature 0.4, top-p 0.9 twice from one seed
     (identical); LLAMA31_8B's widths at 2 layers in fp32 on the card
     against the CPU (loss within 1e-5, trainable gradients within 1e-4 of
     the largest, greedy tokens equal unless the top-2 gap at the first
     differing step is below 1e-4 of the largest logit); then
     python -m medtok_tpu_torch.cli.qa finetune and eval (8 new tokens a
     question) with --tiny and a byte-level tokenizer.json written by the
     phase (the regex-free BPE and the chat template);
 18. the EHR downstream entry point and the export routes that feed it:
     the pandas-free EHR parsers over tests/fixtures/mimic3_demo with every
     table (patient, visit and event counts equal to the constants the CPU
     tests hold to the JAX parsers); medtok_tpu_torch.cli.export --workdir
     with --packed off, then on, at ModelConfig() width in fp32 (phase 5's
     weights and vocabulary written as a user's files), K1 launched 4 times
     a batch of 1024 by the unpacked sweep and no K2, its token rows equal
     to the packed sweep's by phase 5's tie-gap rule, PretrainedMedTok on
     the written files answering three codes equal to their rows; then
     medtok_tpu_torch.cli.ehr --task readmission at its default flags
     (EHRTrainConfig() width, K3 by --flash auto, 1 epoch) on
     MIMIC-III-schema CSVs that the port's synthetic_mimic3 writes for
     46,520 patients over phase 5's vocabulary at MIMIC-III v1.4's rows a
     patient and an admission (v14_rates: about 1.27 admissions a patient,
     11 diagnoses, 4 procedures and 70 prescriptions an admission), with phase 5's
     embeddings_all as the table: each stage's wall time and the fit's
     samples/s logged, K3 fwd / dq / dkv launched, test_metrics.json finite
     and reproduced by the reloaded best_model; a 2-point --hyper-search at
     1 epoch and the other five task builders (sample counts logged,
     phenotype on an index the phase writes) over 4,652 patients written
     the same way;
 19. the host data runtime: NativeWordPiece's ids against the Python
     tokenizer's for every description (both timed); every export group's
     compact batch, copied from the pinned pool and unpacked on the card,
     against the numpy route graph by graph, plus one group forced into the
     16-node bucket (uint16 pairs) and one with the stream threshold lifted
     (int32 pairs); the fence witness (a pool one entry deep, packs while
     earlier copies are queued behind a stall, each device batch against a
     fresh host pack; the same run without fences is logged); the export's
     host half (WordPiece, text rows and compact packs, no model) at 600,000
     synthetic codes, in seconds and codes/s;
 20. the training variants: a GAT + kmeans + revival model at the verify
     recipe's widths in fp32, three packed steps on the card against the
     same steps on the CPU, each from the CPU's state (loss terms within
     1e-5, parameters and the EMA buffers within 1e-5 of each tensor's
     largest, noise-gradient elements set aside and counted, the usage
     FIFO equal), then its export by phase 5's tie-gap rule; kmeans at
     the init's full shape (2048 rows against 21000 means drawn with
     replacement): the duplicated means' columns bit-identical on the
     card, the first assignments, each sample's final counts and the
     means (1e-6) the CPU's; then at ModelConfig() width over phase 5's
     data as a user's files: medtok_tpu_torch.cli.train
     --graph-model-name GAT --kmeans --codebook-revival (packed, bf16,
     batch 1024, 4 steps: step ms, codes/s, peak memory, 6 K1 and 12 K2
     launches a step, K1 on the first step's six sweeps of the k-means
     codebook held to its plain version), cli.export --workdir of it
     (launches, K2 on its first packing held to its plain version),
     MedTok.from_checkpoint of it, and cli.train --text-dropout-in-train
     (GCN, unpacked, 2 steps: 6 K1 and no K2 a step);
 21. data parallel: (a) `python -m torch.distributed.run --standalone
     --nproc-per-node 1 -m medtok_tpu_torch.cli.train` (world 1, NCCL) with
     phase 16's files and flags to step 2, its checkpoint bitwise equal to
     phase 16's (parameters, buffers, Adam state, generator), the group's
     join and warm-up times logged; (b) in a world-1 NCCL group joined by
     this process: phase 15's step (ModelConfig(), bf16, packed, batch
     1024) with the group and without it, alternated on one model and the
     same batches (ms/step of each, the bytes each grouped step
     all-reduces and all-gathers, DataParallel.all_reduce_mean_ and the
     NCCL all-reduce alone timed), 6 K1 and 12 K2 launches a grouped step,
     K1 on its six sweeps and K2 on its packing held to their plain
     versions; (c) EHRTrainer at EHRTrainConfig() width, 2 steps with the
     group and without it: losses and parameters bitwise equal, 4
     launches of each K3 kernel a step; (d) two rank processes sharing the
     card over gloo (this script with --dp-rank): the k-means init of the
     global batch, 3 packed fp32 steps of a GCN + kmeans + revival model at
     the verify recipe's widths and 2 EHR steps (no dropout), the ranks'
     parameters, buffers and Adam moments bitwise equal after every step,
     each step held to its replay on the CPU from the same state in the
     same group (loss terms within 1e-5, gradients within 1e-4 of each
     tensor's largest, token rows by the tie-gap rule), the collectives
     staged through the host on gloo logged;
 22. tensor parallel: two rank processes sharing the card over gloo (this
     script with --tp-rank) on a (dp 1, tp 2) mesh. (a) phase 15's
     training (ModelConfig(), bf16, packed, batch 1024), 3 steps, each
     rank sweeping its half of the 21000-row codebook with K1 (4 launches
     a step each: the shared sweeps, and the one specific region its block
     meets), held to the one-device run on the same card and batches:
     tokens by the tie-gap rule, losses and trained tensors bitwise equal
     unless a token row differed at a tie, the ranks bitwise equal after
     every step, each first-step K1 call held to its plain version;
     (b) QA at LLAMA31_8B's widths cut to 2 layers and B = 4 (bf16, LoRA
     r = 16, nonzero lora_b, remat, total_len 512), 2 steps against the
     one-device port: losses within 1e-2 relative, the gathered lora_b
     within 5e-2 of its largest entry, 16 greedy tokens equal wherever the
     one-device top-2 logit gap exceeds 1e-2; the bytes a step all-reduces
     and its ms beside the one-device step's;
 23. the data-parallel export on phase 18's fp32 workdir (ModelConfig()
     width, the 16,384-code vocabulary as a user's files): (a) `python -m
     torch.distributed.run --standalone --nproc-per-node 1 -m
     medtok_tpu_torch.cli.export --mesh-dp -1` (world 1, NCCL) with
     --packed off and on, each route's arrays bitwise equal to phase 18's
     one-device arrays and its K1 / K2 launches theirs; the export's
     seconds and codes/s beside phase 18's, the gather's seconds and bytes;
     (b) two rank processes sharing the card over gloo (this script with
     --dp-rank --dp-task export) running cli.export --packed on
     --mesh-dp -1: every rank's arrays and rank 0's files bitwise phase
     18's, rank 0 alone printing, each rank's launches 4 K1 and 12 K2 a
     step of its share (steps r, r + 2, ...);
 24. the auxiliaries: (a) examples/quickstart_torch.py and
     examples/downstream_torch.py through their main() with their own
     checks (K1 in the quickstart, K3 in the downstream's EHR encoder,
     counted from 0); (b) ops.ema.norm_ema_quantize at ModelConfig()'s
     21000 x 64 codebook on z [4096, 64] fp32, train and eval, K1 at k = 1
     once a call, held to the plain route on the CPU (indices by the 1e-5
     tie gap, codebook, usage EMA and loss within 1e-6 on the rows no
     differing index touched), over a world-1 NCCL group bitwise equal to
     no group, on two gloo ranks sharing the card (half the rows each)
     equal in indices and within 1e-6 of one device on all rows;
     revival_quantize with each anchor, the closest one within 1e-5 of the
     CPU; (c) utils.zero.apply_zero at stages 0-3 on ModelConfig()'s fp32
     parameters and Adam state (the bytes a rank holds at each), one Adam
     step (foreach=False) on stage-3 DTensors bitwise the replicated step
     over the world-1 NCCL group and within 1e-6 on each of two gloo ranks;
     (d) utils.profiling.trace and StepTimer around a packed export of the
     codes of phase 5's first two export steps, twice: the trace holds the
     export.bert and export.quantize ranges and K1's and K2's kernels;
     (e) ops.drop_path on a [1024, 128, 768] bf16 tensor at p 0.1: kept
     samples exactly x / keep in bf16, the dropped share within 4 sigma.
Phase 5's profile also reports the device time of the Count build
(gcn_norm_adj) in the export's tail node buckets, of K2, and of K1 per
shape (z rows x codebook rows) with its launches.
It then prints the card, one JSON line of kernel measurements (K1's,
K2's and K3's rows add their launches on each path that runs them, K1's on
each tp rank of phase 22, K1's and K2's on each rank of phase 23, K1's and
K3's in the examples and K1's in the norm-EMA quantizer of phase 24) and, last,
{"ok": true, "device": {...}}. Without CUDA, or without the repository
beside it, it exits non-zero and prints no result. fp32 matmuls and
convolutions run in full fp32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import io
import json
import re
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
# above the 3xTF32 kernel's 8: the register lists' 9 and 16, the radix
# select's first k (17), 64 and several hundred (k = N is checked beside)
WIDE_WIDTHS = (257, 320, 512, 1000)
WIDE_K = (9, 16, 17, 64, 500)
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
    pv, pi = vq.topk_smallest(vq.squared_distance(z, e), min(k + 1, e.shape[0]))
    gaps = pv[:, 1:] - pv[:, :-1]                  # [B, k]
    if pv.shape[1] == k:  # k = N: no (k+1)-th, so no near tie at the k-th
        gaps = torch.cat([gaps, torch.full_like(pv[:, :1], float("inf"))], dim=1)
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
    """Exact ties: K1 on z against every codeword of ``base`` twice (copy c
    and c + N0). On every row the picks must be in strict (value, index)
    order; every upper copy picked must have its lower copy picked with a
    bit-identical distance; a lower copy picked without its upper one must
    be where the k-th place splits the pair (the last pick ranks below the
    upper copy). On rows without a near tie (gaps > 1e-5) the picks must be
    the plain version's winners, each lower copy followed by its upper one
    (the last alone when k is odd)."""
    import torch

    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    N0, m = base.shape[0], (k + 1) // 2
    vals, idx = fused_topk_l2(z, torch.cat([base, base]), k=k)
    idx = idx.long()
    v0, v1, i0, i1 = vals[:, :-1], vals[:, 1:], idx[:, :-1], idx[:, 1:]
    check(bool(((v0 < v1) | ((v0 == v1) & (i0 < i1))).all()),
          f"{label}: picks not in strict (value, index) order")
    picked = torch.zeros(z.shape[0], 2 * N0, dtype=torch.bool, device=z.device)
    picked.scatter_(1, idx, True)
    at = torch.full((z.shape[0], 2 * N0), float("nan"), device=z.device)
    at.scatter_(1, idx, vals)
    upper = idx >= N0
    twin = torch.where(upper, idx - N0, idx + N0)
    twin_picked = picked.gather(1, twin)
    check(bool((twin_picked | ~upper).all()
               and (at.gather(1, twin) == vals)[twin_picked].all()),
          f"{label}: an upper copy picked without its lower copy, or their distances differ")
    orphan = ~upper & ~twin_picked  # a lower copy whose upper copy was left out
    last_v, last_i = vals[:, -1:], idx[:, -1:]
    below_twin = (last_v < vals) | ((last_v == vals) & (last_i < twin))
    check(bool(below_twin[orphan].all()),
          f"{label}: a pair split before the k-th place (duplicated rows not ranked "
          "lowest index first)")
    pv, pi = vq.topk_smallest(vq.squared_distance(z, base), m + 1)
    clean = ((pv[:, 1:] - pv[:, :-1]) > 1e-5).all(dim=1)
    want = torch.stack([pi[:, :m], pi[:, :m] + N0], dim=2).reshape(z.shape[0], -1)[:, :k]
    check(torch.equal(idx[clean], want[clean]),
          f"{label}: picks differ from the plain version's winners and their copies")
    log(f"{label}: {z.shape[0]} rows at D={z.shape[1]}, k={k} lowest-index-first over "
        f"{2 * N0} duplicated rows, bit-identical distances for each pair, "
        f"{int(orphan.any(dim=1).sum())} rows with a pair split at the k-th place, "
        f"{int(clean.sum())} rows without near ties the plain version's")


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
    log_host_runtime(dataset, "main path")
    return launches, arrays


def log_host_runtime(dataset, label: str) -> None:
    """The native route's pools and counters: the compact packs ran into
    pinned buffers."""
    from medtok_tpu_torch.utils.profiling import counters

    check(dataset.native is not None, f"{label}: the dataset is not on the native route")
    keys = sorted(dataset.native._pools, key=str)
    pinned = dataset.native.pool_bytes(pinned=True)
    check(pinned > 0, f"{label}: no pinned pool entry was packed")
    entries = sum(len(p) for p in dataset.native._pools.values())
    c = counters()
    log(f"{label}: host runtime: {len(keys)} pools ({entries} entries), "
        f"{pinned / 2**20:.1f} MiB pinned, "
        f"{dataset.native.pool_bytes(pinned=False) / 2**20:.1f} MiB pageable; cumulative: "
        f"native pack {c.get('native.pack_s', 0):.3f} s, "
        f"fence waits {c.get('native.fence_wait_s', 0):.3f} s, "
        f"WordPiece encode {c.get('text.encode_s', 0):.3f} s + "
        f"store {c.get('text.store_s', 0):.3f} s")
    for key in keys:
        pool = dataset.native._pools[key]
        log(f"  pool (B, Ln, Epg, aug, uint16 or stream, pinned) = {key}: depth {len(pool)}, "
            f"{pool[0].nbytes / 2**20:.2f} MiB an entry")


def numpy_route(dataset):
    """The same vocabulary on the numpy route (native=False)."""
    from medtok_tpu_torch.data.dataset import MedCodeDataset

    return MedCodeDataset(dataset.kg, dataset.med_codes, dataset.descs, dataset.pkg_index_lists,
                          dataset.tokenizer, cfg=dataset.cfg, native=False)


def check_numpy_route_export(model, dataset_np, dev, first: dict) -> None:
    """Phase 5's export again on the numpy route (Python WordPiece, numpy
    subgraphs, collate, the compact batch from _compress_classic): its
    artifacts held to the native route's by the tie-gap rule."""
    import torch

    from medtok_tpu_torch.export import export_all_packed

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = export_all_packed(model, dataset_np, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = hold_to_tie_rule(arrays, first, "numpy-route export against the native one")
    log(f"numpy-route export ({len(dataset_np)} codes, cold): {wall:.3f} s wall "
        f"({len(dataset_np) / wall:.1f} codes/s); against the native route: {summary}")


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


def hold_to_tie_rule(got: dict, want: dict, label: str) -> str:
    """Two exports' artifacts: token rows may differ only where the
    reference's picks are tied to within 1e-5 (docs/PARITY.md); embedding
    part p (one per path) is compared within 1e-4 on the rows whose path-p
    tokens agree. Returns the summary it checked."""
    import numpy as np

    rows_equal = (got["tokens_all"] == want["tokens_all"]).all(axis=-1)   # [n, 4]
    gaps = tie_gaps(got["tokens_all"], got["weights_all"],
                    want["tokens_all"], want["weights_all"])
    max_gap = float(gaps.max(initial=0.0))
    d = got["embeddings_all"].shape[1] // 4
    emb_err = max(
        (float(np.abs(got["embeddings_all"][rows_equal[:, p], d * p:d * (p + 1)]
                      - want["embeddings_all"][rows_equal[:, p], d * p:d * (p + 1)]).max())
         for p in range(4) if rows_equal[:, p].any()), default=0.0)
    check(max_gap <= 1e-5, f"{label}: token rows differ beyond a tie "
          f"(gaps {sorted(gaps.tolist())[-10:]} > 1e-5)")
    check(emb_err <= 1e-4, f"{label}: embedding error {emb_err} > 1e-4")
    return (f"{int((~rows_equal).sum())}/{rows_equal.size} token rows differ, max tie gap "
            f"{max_gap:.3e}; embedding max err {emb_err:.3e} on the other rows")


def check_reference(model, dataset, dev, n_codes: int = 64,
                    label: str = "fp32 reference") -> None:
    """A small fp32 export with the kernels on the card against the same
    export with the plain versions on the CPU. Token rows may differ only
    where the reference's picks are tied to within 1e-5 (docs/PARITY.md);
    embeddings are compared on the paths whose tokens agree."""
    import dataclasses

    import torch

    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.export import export_all_packed
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.utils.checkpoint import load_weights

    sub = MedCodeDataset(dataset.kg, dataset.med_codes[:n_codes], dataset.descs[:n_codes],
                         dataset.pkg_index_lists[:n_codes], dataset.tokenizer,
                         cfg=dataset.cfg)
    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    state = {k: v.float() for k, v in model.state_dict().items()}
    # the buffers the state_dict leaves out: the usage FIFO, the EMA codebook
    buffers = {k: v for k, v in model.named_buffers() if k not in state}
    out = []
    for where in (dev, torch.device("cpu")):
        m = load_weights(MultimodalTokenizer(cfg32, device=where),
                         {"model": state, "buffers": buffers})
        out.append(export_all_packed(m, sub, device=where, num_rows=8))
        del m
    summary = hold_to_tie_rule(*out, label)
    log(f"{label} ({n_codes} codes, kernels on the card vs plain on the CPU): {summary}")


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
    Returns the largest absolute errors and ("shares") the share of each
    output's elements that differ."""
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
            "dkv": max(res["dk"]["max_abs"], res["dv"]["max_abs"]),
            "shares": {key: r["share"] for key, r in res.items()}}


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
    fused_topk_l2.select_launches = 0
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
    """Name in the kernels line -> (the wrapper, the attribute that counts
    that wide route's launches): K1's radix select above k 16 counts apart
    (``select_launches``, a part of K1's ``wide_launches``)."""
    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    return {"topk_l2_wide": (fused_topk_l2, "wide_launches"),
            "topk_l2_wide_select": (fused_topk_l2, "select_launches"),
            "segment_attention_wide": (fa.packed_segment_attention, "wide_launches"),
            "segment_attention_nt_wide": (fa.packed_segment_attention_nt, "wide_launches"),
            "flash_attention_fwd_wide": (fa.flash_attention_fwd, "wide_launches"),
            "flash_attention_dq_wide": (fa.flash_attention_dq, "wide_launches"),
            "flash_attention_dkv_wide": (fa.flash_attention_dkv, "wide_launches")}


def wide_launches() -> dict:
    return {name: getattr(f, attr) for name, (f, attr) in wide_counters().items()}


def check_wide_routes(gen, dev) -> dict:
    """The wide routes against their plain versions by the checks of phases
    3, 4, 7 and 10, in both dtypes where the kernel has both: K3 fwd / dq /
    dkv at WIDE_WIDTHS (fp32 through autograd at L = 600, bf16 at Lq = 300
    against Lk = 1100, dropout 0.5, width_masks), K2 and K4 at WIDE_WIDTHS
    (edge_segments at L = 300), K1 at WIDE_WIDTHS with k in WIDE_K and k =
    N (512 rows against 3000 codewords and their last third), the same k at
    the built width 64, exact ties at D = 320 (k 16; k 63, 64, 501 and 4097
    for the radix select, ties straddling the k-th place at odd k), z rows
    equal to codewords (k1_near_zero) and rows whose keys stay in device
    memory (k1_global_row). Returns each route's largest error (bf16 for
    the attention routes, as the kernels line reports them); K1's above k
    16 apart, as "topk_l2_wide_select"."""
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
    def k1(z, e, label, k):
        name = "topk_l2_wide_select" if k > 16 else "topk_l2_wide"
        errs[name] = max(errs[name], check_k1_case(z, e, label, k=k))

    for Dk in WIDE_WIDTHS:
        z, cb = unit_rows(gen, dev, 512, Dk), unit_rows(gen, dev, 3000, Dk)
        for label, e in (("full", cb), ("region", vq.region_slice(cb, "graph"))):
            for k in (*WIDE_K, e.shape[0]):
                k1(z, e, f"wide D={Dk} {label}", k)
    z, cb = unit_rows(gen, dev, 512, D), unit_rows(gen, dev, 3000, D)
    for k in (*WIDE_K, cb.shape[0]):
        k1(z, cb, f"wide k, D={D} full", k)
    check_k1_ties(unit_rows(gen, dev, 512, 320), unit_rows(gen, dev, 1500, 320), 16,
                  "K1 wide ties")
    # ties straddling the k-th place (odd k) and not (even), at the radix
    # select's shared-memory sort and (k 4097) its global sort
    for k in (63, 64, 501):
        check_k1_ties(unit_rows(gen, dev, 512, 320), unit_rows(gen, dev, 1500, 320), k,
                      f"K1 wide ties k={k}")
    check_k1_ties(unit_rows(gen, dev, 128, 320), unit_rows(gen, dev, 3000, 320), 4097,
                  "K1 wide ties k=4097")
    k1_near_zero(gen, dev, errs)
    k1_global_row(gen, dev, errs)
    k1_select_signs(gen, dev)
    return errs


def k1_near_zero(gen, dev, errs: dict) -> None:
    """z rows equal to codewords whose entries are exact in TF32 (lo = 0,
    so the 3xTF32 sums carry no lo.lo term): each row's own distance is 0
    up to the rounding of the sums, whose signs the log counts (the plain
    version's fp32 sums give both signs; signed zeros and negative values
    the sweep does not give reach the selection in k1_select_signs). K1-wide
    at k 17 and 64 against the plain version."""
    import torch

    cb = unit_rows(gen, dev, 3000, 320)
    cb = (cb.view(torch.int32) & ~0x1FFF).view(torch.float32)
    z = cb[torch.randperm(3000, generator=gen, device=dev)[:512]].contiguous()
    for k in (17, 64):
        errs["topk_l2_wide_select"] = max(errs["topk_l2_wide_select"], check_k1_case(
            z, cb, "wide, z rows = codewords", k=k))
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    own = fused_topk_l2(z, cb, k=17)[0][:, 0]
    log(f"K1 wide, z rows = codewords: the own distance (first pick) < 0 in "
        f"{int((own < 0).sum())}, = 0 in {int((own == 0).sum())}, > 0 in "
        f"{int((own > 0).sum())} of 512 rows, within [{float(own.min()):.3e}, "
        f"{float(own.max()):.3e}]")


def k1_select_signs(gen, dev) -> None:
    """The radix select alone (``select_smallest``) on rows the sweep does
    not give it (its distances for z rows equal to codewords come out
    positive): half the entries from a pool of signed zeros, tiny and
    subnormal values of both signs, +-1 and NaN, half normals of scale 1e-6,
    so that nearly every row ties at the k-th place. Held to the plain
    stable sort run on the CPU: indices equal and values bit for bit (the
    sign of zero included); shared-memory sorts (k up to 4,096) and the
    global one, keys in shared and in device memory."""
    import torch

    from medtok_tpu_torch.ops.topk_l2 import select_plan, select_smallest
    from medtok_tpu_torch.ops.vq import topk_smallest

    pool = torch.tensor([-0.0, 0.0, -1e-7, 1e-7, -2.5e-6, 2.5e-6, -1.4e-45, 1.4e-45, -1.0,
                         1.0, float("nan")], device=dev)
    select_smallest.launches = 0
    done = []
    for B, N, ks in ((512, 3000, (17, 64, 501, 3000)), (64, 6000, (5000,)),
                     (16, 60000, (64, 5000))):
        pick = torch.randint(0, len(pool), (B, N), generator=gen, device=dev)
        d = torch.where(torch.rand(B, N, generator=gen, device=dev) < 0.5, pool[pick],
                        1e-6 * torch.randn(B, N, generator=gen, device=dev)).contiguous()
        for k in ks:
            vals, idx = select_smallest(d, k)
            pv, pi = topk_smallest(d.cpu(), k)
            check(torch.equal(idx.cpu().long(), pi)
                  and torch.equal(vals.cpu().view(torch.int32), pv.view(torch.int32)),
                  f"K1 select alone [{B}, {N}], k={k}: differs from the stable sort on the CPU")
            done.append((N, k, select_plan(N, k)[:2]))
    check(select_smallest.launches == len(done),
          f"K1 select alone: {select_smallest.launches} launches for {len(done)} calls")
    log(f"K1 select alone on signed zeros, subnormals, ties and NaN: (N, k, (row_shared, "
        f"sort_shared)) {done} each bit for bit the CPU's stable sort")


def k1_global_row(gen, dev, errs: dict) -> None:
    """The radix select where a row's keys do not fit in shared memory
    (60,000 codewords): each pass reads the distances again; k 17 and 64
    sort in shared memory, k 5000 and k = N through global scratch."""
    from medtok_tpu_torch.ops import topk_l2

    z, cb = unit_rows(gen, dev, 256, 320), unit_rows(gen, dev, 60000, 320)
    for k in (17, 64, 5000, 60000):
        plan = topk_l2.wide_plan(256, 60000, 320, k, 132)
        check(not plan.row_shared and plan.sort_shared == (k <= 4096),
              f"K1 wide, 60,000 codewords: plan {plan}")
        errs["topk_l2_wide_select"] = max(errs["topk_l2_wide_select"], check_k1_case(
            z, cb, "wide, keys in device memory", k=k))


def wide_times(gen, dev, errs: dict, ran: dict) -> list[dict]:
    """Each wide route timed at one shape beside its plain version, the
    library call for its function and its bound, as rows of the kernels
    line (``ran``: the width phase's launches of each). A bound is the
    function's, whatever the route's design: its operations at the card's
    peak for the inputs' type, as the kernels' own rows count them (K1's
    fp32 products as 3xTF32, 3 x 2 B N D operations at the TF32 peak; bf16
    attention at the bf16 peak), or its bytes, whichever is slower. K1 at z
    [4096, 320] against 21000 codewords, k = 9 and (the radix select) k =
    64; K2 / K4 bf16 at [256, 4,
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
    B, N, Dk = 4096, 21000, 320
    z, cb = unit_rows(gen, dev, B, Dk), unit_rows(gen, dev, N, Dk)

    def library(k):
        d = (z * z).sum(1, keepdim=True) + (cb * cb).sum(1)[None] - 2.0 * (z @ cb.T)
        return torch.topk(d, k, dim=1, largest=False)

    # k 9 (a register list of 16) and k 64 (the radix select, two chunks of
    # 3,195 rows, held to the plain version here first)
    errs["topk_l2_wide_select"] = max(errs["topk_l2_wide_select"], check_k1_case(
        z, cb, "wide, wide_times' shape (two chunks)", k=64))
    for name, k in (("topk_l2_wide", 9), ("topk_l2_wide_select", 64)):
        rows.append(row(name, "topk_l2.cu", "medtok_tpu/ops/vq_pallas.py:139",
                        cuda_ms(lambda: fused_topk_l2(z, cb, k=k), 5),
                        cuda_ms(lambda: fused_topk_l2_reference(z, cb, k), 3),
                        cuda_ms(lambda: library(k), 5), 3 * 2.0 * B * N * Dk, PEAK_TF32,
                        4.0 * (B + N) * Dk + 8.0 * B * k))
    log(f"topk_l2_wide at the paths' k = {K} (a list of 8; the rows above: k = 9, a "
        f"list of 16, and k = 64, the radix select): kernel "
        f"{cuda_ms(lambda: fused_topk_l2(z, cb, k=K), 5):.4f} ms; the radix select's "
        f"route at k 17 {cuda_ms(lambda: fused_topk_l2(z, cb, k=17), 5):.4f} ms, at k 1000 "
        f"{cuda_ms(lambda: fused_topk_l2(z, cb, k=1000), 5):.4f} ms")
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


@contextlib.contextmanager
def wide_inputs_of_path():
    """Keeps a copy of the inputs of the first bf16 launch of K2's wide
    kernel ("K2": q, k, v, seg_ids, sm_scale), of K3's wide forward ("K3":
    q, k, v, key_mask and the keywords) and of K1's wide route ("K1": z,
    the codebook rows, k) while the block runs, by wrapping the wrappers'
    launch helpers; the launches and their counts are the path's own."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops import topk_l2

    seen = {}
    segment_wide, k3_launch, k1_wide = fa._segment_wide, fa._k3_launch, topk_l2._wide

    def k1_kept(z, codebook, k):
        if "K1" not in seen:
            seen["K1"] = (z.clone(), codebook.clone(), k)
        return k1_wide(z, codebook, k)

    def segment_kept(nt, q, k, v, seg_ids, heads, sm_scale):
        if q.dtype == torch.bfloat16 and not nt and "K2" not in seen:
            seen["K2"] = (*(t.clone() for t in (q, k, v, seg_ids)), sm_scale)
        return segment_wide(nt, q, k, v, seg_ids, heads, sm_scale)

    def k3_kept(entry, q, k, tensors, sm_scale, dropout_rate, dropout_seed, extra=()):
        if entry == "medtok_flash_fwd_wide_mma" and "K3" not in seen:
            seed = dropout_seed.clone() if torch.is_tensor(dropout_seed) else dropout_seed
            seen["K3"] = (*(t.clone() for t in tensors[:4]),
                          dict(sm_scale=sm_scale, dropout_rate=dropout_rate, dropout_seed=seed))
        return k3_launch(entry, q, k, tensors, sm_scale, dropout_rate, dropout_seed, extra)

    fa._segment_wide, fa._k3_launch, topk_l2._wide = segment_kept, k3_kept, k1_kept
    try:
        yield seen
    finally:
        fa._segment_wide, fa._k3_launch, topk_l2._wide = segment_wide, k3_launch, k1_wide


def hold_k2_wide_path(q, k, v, seg, sm_scale: float) -> dict:
    """K2's wide kernel against its plain version on the export path's own
    bf16 inputs (Bf16Tally's rule, padding rows 0), and K4 bit for bit K2
    on the transposed inputs."""
    import torch

    from medtok_tpu_torch.ops import flash_attention as fa

    out = fa.packed_segment_attention(q, k, v, seg, sm_scale=sm_scale)
    tally = Bf16Tally()
    plain = fa.packed_segment_attention_reference
    tally.add(out, plain(q, k, v, seg, sm_scale=sm_scale),
              plain(q.float(), k.float(), v.float().abs(), seg, sm_scale=sm_scale))
    res = tally.check(f"K2 wide on the export path {list(q.shape)}")
    pad = (seg == 0)[:, None, :].expand(q.shape[:3])
    check(bool((out[pad] == 0).all()), "K2 wide on the export path: a padding row is not 0")
    qt, kt, vt = heads_first(q, k, v)  # [B, H, L, Dh] <-> [B, L, H, Dh]: the same swap
    out_nt = fa.packed_segment_attention_nt(qt, kt, vt, seg, sm_scale=sm_scale)
    check(torch.equal(out_nt.transpose(1, 2), out),
          "K4 wide on the export path's inputs is not bit for bit K2")
    log(f"K2 wide on the export path's inputs q {list(q.shape)} bf16, "
        f"{float((seg > 0).float().mean()):.3f} of the tokens valid: vs the bf16 plain version "
        f"{100 * res['share']:.4f}% differ (max abs {res['max_abs']:.3e}, "
        f"{res['beyond_ulp']} beyond one ulp of the value), 0 beyond the tolerance; padding "
        f"rows 0; K4 on the transposed inputs bit for bit K2")
    return res


def check_wide_paths(table, ehr: dict, dataset, dev, gen, n: int = 16) -> dict:
    """The entry points' flags that reach the wide routes, on the card:
    EHRTrainer at head width 320 (EHRTrainConfig(input_dim=640,
    output_dim=640, num_heads=2), what cli.ehr --input-dim 640 --output-dim
    640 --num-heads 2 builds; K3 gets bf16 under "default") trains two steps
    on n samples of an eval batch, each layer launching K3's wide forward,
    dq and dkv once a step, finite losses; and one packed export step of
    256 codes at ModelConfig() with the text encoder at 2 heads of the 768
    width (head width 384, what cli.train --text-heads 2 sets) and a
    codebook 320 wide (cli.train --codebook-embed-dim 320
    --graph-out-channels 320: the graph encoder's output is the codebook's
    width) launches K2's wide kernel once a BERT layer and K1's wide route
    (k = 5) once for each of the step's 4 sweeps, finite outputs. Then each
    kernel is held to its plain version on the first inputs the path gave
    it (wide_inputs_of_path): K3 by check_k3_bf16, K2 by hold_k2_wide_path,
    K1 by check_k1_case; K3's wide route also at 1100 and 4,096 queries
    (the differing shares logged beside the path's at 2003). Returns each
    wide route's launches by path."""
    import numpy as np
    import torch

    from medtok_tpu_torch.config import (
        GraphEncoderConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
    )
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer
    from medtok_tpu_torch.export import export_all_packed, export_groups
    from medtok_tpu_torch.models.layers import init_random_
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    t0 = time.perf_counter()
    cfg = dataclasses.replace(EHRTrainConfig(), input_dim=640, output_dim=640, num_heads=2)
    trainer = EHRTrainer(cfg, table, 2, device=dev)
    check(trainer.use_flash, "EHR head width 320: K3 was not picked on the card")
    first = ehr["eval"][0]
    batch = type(first)(*(x[:n] for x in first))
    k3 = {"fwd": fa.flash_attention_fwd, "dq": fa.flash_attention_dq,
          "dkv": fa.flash_attention_dkv}
    for f in k3.values():
        f.launches = f.wide_launches = 0
    with wide_inputs_of_path() as seen:
        losses = [float(trainer.train_step(batch)[0]) for _ in range(2)]
        torch.cuda.synchronize()
    ehr_wide = {key: f.wide_launches for key, f in k3.items()}
    want = dict.fromkeys(k3, 2 * cfg.num_layers)
    check(ehr_wide == want and not any(f.launches for f in k3.values()),
          f"EHR head width 320: K3 wide launches {ehr_wide} != {want}")
    check(all(map(np.isfinite, losses)), f"EHR head width 320: losses {losses}")
    log(f"wide path: EHRTrainer input_dim = output_dim = 640, 2 heads (head width 320): "
        f"two train steps on {n} samples, losses {losses}, K3 wide launches {ehr_wide}")
    del trainer
    q, k, v, mask, kw = seen.pop("K3")
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    check(q.dtype == torch.bfloat16 and q.shape[2:] == (mask.shape[1], 320),
          f"EHR head width 320: K3's wide forward got q {q.dtype} {list(q.shape)}")
    shares = {q.shape[2]: check_k3_bf16(q, k, v, do, mask, kw,
                                        "wide, on the EHR path's inputs")["shares"]}
    del q, k, v, mask, do
    # the wide route at wide_times' 1100 queries (every key valid) and at
    # 4,096 (one batch row every key, one a prefix of 2,500): the share of
    # out, dq, dk and dv that differs grows with the keys and queries summed
    for Bf, L, lens in ((8, 1100, None), (2, 4096, (4096, 2500))):
        q, k, v, do = (torch.randn(Bf, 2, L, 320, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        lens_t = torch.full((Bf, 1), L, device=dev) if lens is None else \
            torch.tensor(lens, device=dev)[:, None]
        wkw = dict(sm_scale=1.0 / 320 ** 0.5, dropout_rate=0.5, dropout_seed=K3_SEED)
        wmask = torch.arange(L, device=dev)[None] < lens_t
        shares[L] = check_k3_bf16(q, k, v, do, wmask, wkw, f"wide at {L} queries")["shares"]
        del q, k, v, do
    log("K3 wide route, bf16 [B*2, L, 320], dropout 0.5: the share of the elements "
        "that differ from the bf16 plain version by L, the queries and keys summed: "
        + "; ".join(f"L {L}: " + ", ".join(f"{key} {100 * sh[key]:.4f}%"
                                           for key in ("out", "dq", "dk", "dv"))
                    for L, sh in sorted(shares.items())))

    codes = 256
    sub = MedCodeDataset(dataset.kg, dataset.med_codes[:codes], dataset.descs[:codes],
                         dataset.pkg_index_lists[:codes], dataset.tokenizer, cfg=dataset.cfg)
    mcfg = ModelConfig(text=TextEncoderConfig(num_heads=2),
                       graph=GraphEncoderConfig(out_channels=320),
                       quantizer=QuantizerConfig(codebook_embed_dim=320))
    model = init_random_(MultimodalTokenizer(mcfg, device=dev), gen).eval()
    seg = fa.packed_segment_attention
    seg.launches = seg.wide_launches = 0
    fused_topk_l2.launches = fused_topk_l2.wide_launches = 0
    with wide_inputs_of_path() as seen:
        arrays = export_all_packed(model, sub, device=dev)
        torch.cuda.synchronize()
    steps = len(export_groups(sub))
    want_k2 = mcfg.text.num_layers * steps
    check(steps == 1 and seg.wide_launches == want_k2 and seg.launches == 0,
          f"export at text heads 2: {steps} steps, K2 wide launches {seg.wide_launches} "
          f"(want {want_k2}), narrow {seg.launches}")
    # the path's own launches, before the holds below launch the kernels again
    k2_wide, k1_wide = seg.wide_launches, fused_topk_l2.wide_launches
    check(k1_wide == 4 * steps and fused_topk_l2.launches == 0,
          f"export at codebook width 320: K1 wide launches {k1_wide}, narrow "
          f"{fused_topk_l2.launches}")
    emb, w = arrays["embeddings_all"], arrays["weights_all"]
    check(emb.shape == (codes, mcfg.embedding_dim)
          and bool(np.isfinite(emb).all() and np.isfinite(w).all()),
          f"export at text heads 2, codebook 320: embeddings {emb.shape}, non-finite outputs")
    log(f"wide path: packed export of {codes} codes in {steps} step at ModelConfig() with "
        f"{mcfg.text.num_heads} text heads of the {mcfg.text.hidden_size} width (head width "
        f"{mcfg.text.hidden_size // mcfg.text.num_heads}) and a codebook "
        f"{mcfg.quantizer.codebook_embed_dim} wide: K2 wide launches {k2_wide}, "
        f"K1 wide launches {k1_wide} (k = {mcfg.quantizer.top_k}), {mcfg.compute_dtype}, "
        f"outputs finite")
    del model
    q, k, v, seg_ids, sm_scale = seen.pop("K2")
    check(q.dtype == torch.bfloat16 and q.shape[1:] == (2, seg_ids.shape[1], 384),
          f"export at text heads 2: K2's wide kernel got q {q.dtype} {list(q.shape)}")
    hold_k2_wide_path(q, k, v, seg_ids, sm_scale)
    z, e, k1_k = seen.pop("K1")
    check(z.shape[1] == e.shape[1] == 320 and k1_k == mcfg.quantizer.top_k,
          f"export at codebook width 320: K1's wide route got z {list(z.shape)}, "
          f"e {list(e.shape)}, k {k1_k}")
    check_k1_case(z, e, "wide, on the export path's inputs", k=k1_k)
    log(f"wide paths: {time.perf_counter() - t0:.2f} s for both, their kernels held included")
    return {"segment_attention_wide": {"export, text 768 / 2 heads (phase 14)": k2_wide},
            "topk_l2_wide": {"export, codebook 320 wide (phase 14)": k1_wide},
            **{f"flash_attention_{key}_wide": {"EHRTrainer 640 / 2 heads (phase 14)": c}
               for key, c in ehr_wide.items()}}


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
    ms each took to build."""
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


def run_training(dataset, dataset_np, dev, gen) -> dict:
    """Trainer.fit at ModelConfig() width, packed text, batch 1024, over
    epoch_batches of the export's dataset: a warm-up step that records K1's
    inputs, TRAIN_TIMED_STEPS steps over batches built in advance (the
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
    # the numpy route builds the same graphs with its own dropout bits
    batches_np, collate_np_ms = train_batches(dataset_np, cfg, T + 3)
    for i, (b, b_np) in enumerate(zip(batches, batches_np)):
        same_graphs(b, b_np, f"training batch {i}, native vs numpy route")
    del batches_np
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

    # the step alone, over batches built in advance (pack + copies + step)
    torch.cuda.reset_peak_memory_stats()
    state, step_wall, _ = timed_fit(state, batches[1:1 + T])
    peak = torch.cuda.max_memory_allocated()
    # end to end, as a user runs it: Trainer.fit drawing from epoch_batches,
    # the native batch build with its edge dropout inside the clock
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
        f"{1e3 * wall / T:.3f} ms/step, {TRAIN_BATCH * T / wall:.1f} codes/s (native batch "
        f"build with edge dropout + pack + copies + step); launches {launches}")
    log(f"training step alone: {T} steps over batches built in advance in "
        f"{step_wall:.3f} s: {1e3 * step_wall / T:.3f} ms/step, "
        f"{TRAIN_BATCH * T / step_wall:.1f} codes/s (pack + copies + step); "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"training: host batch build per batch of {TRAIN_BATCH}: native route "
        f"{np.mean(collate_ms):.1f} ms (C++ pack with edge dropout), numpy route "
        f"{np.mean(collate_np_ms):.1f} ms (numpy subgraphs + collate with edge dropout; "
        f"the same graphs), + {np.mean(pack_ms):.1f} ms text packing")
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


def run_clis(seed: int, dev, keep: Path) -> dict:
    """Phase 16: the train and export CLIs at ModelConfig() width, on files
    they read as a user's: a synthetic kg.csv of 130,000 nodes and
    CLI_KG_EDGES edges, a CLI_CODES-code codes.jsonl and the vocab.txt.
    cli.train to step 2 with a checkpoint every step (two kept), then
    --workdir to step 4 (resumed from 2; 0000003.pt and 0000004.pt left),
    then cli.export --workdir, each with K1 and K2 launched; then
    MedTok.from_checkpoint on the first 256 codes held to the export's rows
    by phase 5's tie-gap rule. fp32 compute (--mixed-precision none): the
    API's unpacked text path and the export's packed one round differently
    in bf16 (phase 15 trains in bf16). The files, the first run's argv and
    its step-2 checkpoint stay under ``keep`` for phase 21. Returns the
    runs' wall times and launches, and the argv."""
    import json
    import shutil

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
    root = keep
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
    shutil.copyfile(mgr.path(2), keep / "phase16_step2.pt")
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
    return dict(runs=runs, checkpoint_bytes=size, argv=argv)


# -------------------------------------------------------------------- QA --

QA_BATCH = 16           # the reference finetune's shape: B = 16, cutoff 256,
QA_CUTOFF = 256         # total_len 512
QA_TOTAL = 512
QA_NEW_TOKENS = 32
QA_TIMED_STEPS = 3
QA_LORA_RANK = 16
QA_MISS_ROWS = 100
# the card-against-CPU check: LLAMA31_8B's widths at 2 layers in fp32
QA_REF_LAYERS = 2
QA_REF_BATCH = 2
QA_REF_CUTOFF = 64
QA_REF_NEW_TOKENS = 16
QA_CLI_NEW_TOKENS = 8       # cli.qa eval's tokens a question (its own default: 64)
QA_TOKENIZER_MERGES = 240   # 256 bytes + 240 merges + 5 specials: ids < 512
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eot_id|>")
QA_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "medmcqa_200.json"


def write_tokenizer_json(path, texts, num_merges: int = QA_TOKENIZER_MERGES) -> dict:
    """A byte-level BPE ``tokenizer.json`` in the Llama-3 layout (Split by
    the Llama-3 pattern, then ByteLevel, ``ignore_merges``): the 256 byte
    tokens (id = byte), ``num_merges`` merges counted from ``texts`` (the
    most frequent adjacent pair first, ties to the larger pair), then the
    five Llama-3 specials. Returns the JSON."""
    from collections import Counter

    from medtok_tpu_torch.qa.tokenizer import (
        LLAMA3_SPLIT_PATTERN,
        bytes_to_unicode,
        split_llama3,
    )

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    words = Counter(tuple(b2u[b] for b in piece.encode("utf-8"))
                    for t in texts for piece in split_llama3(t))
    merges = []
    for _ in range(num_merges):
        pairs = Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    added = [{"id": len(vocab) + i, "content": s, "special": True}
             for i, s in enumerate(LLAMA3_SPECIALS)]
    j = {"added_tokens": added,
         "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
             {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT_PATTERN},
              "behavior": "Isolated", "invert": False},
             {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
              "use_regex": False}]},
         "model": {"type": "BPE", "vocab": vocab, "merges": merges, "ignore_merges": True}}
    Path(path).write_text(json.dumps(j))
    return j


def qa_rows(tokenize, cutoff: int, with_answer: bool) -> list[dict]:
    """The fixture's MedMCQA rows packed by pack_example (plain prompt
    template, answer tokens for training)."""
    from medtok_tpu_torch.qa.datasets import load_qa_rows
    from medtok_tpu_torch.qa.prompting import build_prompt, pack_example

    out = []
    for r in load_qa_rows(QA_FIXTURE):
        q, a = r["input"][:2]
        out.append(pack_example(tokenize(build_prompt(q)),
                                tokenize(str(a)) if with_answer else [],
                                r["medical_codes"], cutoff_len=cutoff))
    return out


def qa_step_flops(cfg, B: int, L: int, window: int) -> float:
    """Matmul FLOPs of one remat finetune step: the layers' projections
    three times (forward, recompute, input gradients: the frozen weights
    get none), the attention products four times (their backward is two
    products a forward one), the LM head on the label window twice."""
    E, I, H, KV = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads, cfg.num_kv_heads
    Dh = E // H
    proj = 2 * B * L * (2 * E * E + 2 * E * KV * Dh + 3 * E * I)
    attn = 4 * B * H * L * L * Dh
    head = 2 * B * window * E * cfg.vocab_size
    return cfg.num_layers * (3 * proj + 4 * attn) + 2 * head


def kernel_wrappers() -> dict:
    """Name -> the wrapper of each kernel K1-K5 (``launches``; K1-K4 also
    count their wide routes in ``wide_launches``)."""
    from medtok_tpu_torch.ops import adj_count as ac
    from medtok_tpu_torch.ops import flash_attention as fa
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    return {"topk_l2": fused_topk_l2, "segment_attention": fa.packed_segment_attention,
            "segment_attention_nt": fa.packed_segment_attention_nt,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv,
            "adj_count": ac.adj_count, "adj_count_onehot": ac.adj_count_onehot}


def kernel_launches() -> dict:
    return {name: f.launches + getattr(f, "wide_launches", 0)
            for name, f in kernel_wrappers().items()}


def qa_kernel_class(name: str) -> str:
    """A coarse class of a device kernel by its name."""
    low = name.lower()
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        return "fp32 GEMM" if ("f32f32_f32f32" in low or "sgemm" in low) else "bf16 GEMM"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other"


def qa_profile(fn) -> dict:
    """fn() under torch.profiler: its wall time, the device time of its
    kernels by class and the five largest, the device's busy share."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    gpu = torch.autograd.DeviceType.CUDA
    by_class, by_name = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == gpu and not getattr(e, "is_user_annotation", False):
            us = e.time_range.end - e.time_range.start
            by_class[qa_kernel_class(e.name)] += us / 1e3
            by_name[e.name[:60]] += us / 1e3
    device = sum(by_class.values())
    check(device > 0, "QA profile: no device time was recorded")
    return dict(wall_ms=wall, device_ms=device, classes=dict(by_class.most_common()),
                top=by_name.most_common(5))


def qa_profile_line(label: str, p: dict) -> str:
    classes = ", ".join(f"{k} {v:.3f}" for k, v in p["classes"].items())
    top = "; ".join(f"{n} {v:.3f}" for n, v in p["top"])
    return (f"{label}: wall {p['wall_ms']:.3f} ms under the profiler, device {p['device_ms']:.3f}"
            f" ms (busy {p['device_ms'] / p['wall_ms']:.1%}); by class (ms): {classes}; "
            f"largest kernels (ms): {top}")


def qa_fingerprint(params) -> "torch.Tensor":
    """One float64 sum per tensor (a changed weight changes its sum)."""
    import torch

    return torch.stack([p.detach().double().sum() for p in params])


def qa_finetune(ft, rows, dev) -> dict:
    """1 warm-up and QA_TIMED_STEPS timed steps of ft.train_step on batches
    of fit's order; the checks of a finetune step."""
    import numpy as np
    import torch

    from medtok_tpu_torch.qa.finetune import _collate_rows

    cfg = ft.cfg
    order = np.random.default_rng(cfg.seed).permutation(len(rows))
    batches = [_collate_rows([rows[i] for i in order[s * QA_BATCH:(s + 1) * QA_BATCH]],
                             cutoff_len=cfg.cutoff_len) for s in range(1 + QA_TIMED_STEPS)]
    frozen = [p for _, p in ft.named_parameters() if not p.requires_grad]
    trainable = dict((n, p) for n, p in ft.named_parameters() if p.requires_grad)
    before = qa_fingerprint(frozen)
    start = {n: p.detach().clone() for n, p in trainable.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss = ft.train_step(batch)
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"QA finetune: losses {losses}")
    check(torch.equal(before, qa_fingerprint(frozen)), "QA finetune: a base weight changed")
    check(all(p.grad is None for p in frozen), "QA finetune: a base weight has a gradient")
    still = [n for n, p in trainable.items() if torch.equal(p, start[n])]
    check(not still, f"QA finetune: trainable tensors did not move: {still}")
    prof = qa_profile(lambda: ft.train_step(batches[-1]))
    log(qa_profile_line("QA finetune, one profiled step", prof))
    ms = float(np.mean(times[1:]))
    flops = qa_step_flops(ft.llm_cfg, QA_BATCH, cfg.total_len, cfg.total_len - cfg.cutoff_len)
    out = dict(ms_per_step=ms, step_ms=times, tokens_per_s=QA_BATCH * cfg.total_len / ms * 1e3,
               peak_gib=peak, losses=losses, flops=flops, bound_ms=flops / PEAK_BF16 * 1e3)
    log(f"QA finetune (LLAMA31_8B bf16, LoRA r={QA_LORA_RANK} on q/v, remat, B={QA_BATCH}, "
        f"cutoff {cfg.cutoff_len}, total_len {cfg.total_len}): warm-up {times[0]:.3f} ms, "
        f"steps {[round(t, 3) for t in times[1:]]} ms, mean {ms:.3f} ms/step, "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {peak:.3f} GiB, losses "
        f"{[round(x, 4) for x in losses]}; bound {flops:.4g} FLOP at the bf16 peak = "
        f"{out['bound_ms']:.3f} ms ({out['bound_ms'] / ms:.1%} of the step)")
    return out


def qa_generate(ft, rows, dev, seed: int) -> dict:
    """Soft-prompted generate at B = QA_BATCH, total_len QA_TOTAL, 32 new
    tokens: greedy without eos (timed: prefill and decode ms/token from the
    streaming route's per-token times), greedy with an eos id that every row
    reaches (early exit, eos fill), and sampling twice from one seed."""
    import numpy as np
    import torch

    from medtok_tpu_torch.qa.finetune import _collate_rows
    from medtok_tpu_torch.qa.llama import generate

    batch = _collate_rows(rows[:QA_BATCH], cutoff_len=ft.cfg.cutoff_len)
    with torch.no_grad():
        packed = ft.soft_prompt(torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev),
                                torch.as_tensor(batch["attention_mask"], dtype=torch.long,
                                                device=dev),
                                None, ft.model.embed, ft.cfg.total_len)
    args = (ft.model, packed.inputs_embeds, packed.attention_mask)
    kw = dict(max_new_tokens=QA_NEW_TOKENS, device=dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = generate(*args, temperature=0.0, **kw)
    wall = time.perf_counter() - t0
    check(greedy.shape == (QA_BATCH, QA_NEW_TOKENS)
          and ((greedy >= 0) & (greedy < ft.llm_cfg.vocab_size)).all(),
          f"QA generate: greedy tokens {greedy.shape}")
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = generate(*args, temperature=0.0, on_token=lambda t: stamps.append(
        time.perf_counter()), **kw)
    check(np.array_equal(streamed, greedy), "QA generate: the streaming route's greedy tokens "
          "differ from the batch route's")
    prefill_ms = 1e3 * (stamps[0] - t0)
    decode_ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)

    # an eos every row emits: the loop ends at the step the last row reaches it
    counts = [set(r.tolist()) for r in greedy]
    common = set.intersection(*counts)
    first_hit = {t: max(int(np.argmax(r == t)) for r in greedy) for t in common}
    eos = min(first_hit, key=first_hit.get) if common else int(np.bincount(greedy[:, 0]).argmax())
    steps = []
    with_eos = generate(*args, temperature=0.0, eos_token_id=eos, on_token=steps.append, **kw)
    padded = generate(*args, temperature=0.0, eos_token_id=eos, **kw)
    want_steps = first_hit[eos] + 1 if common else QA_NEW_TOKENS
    check(len(steps) == want_steps, f"QA generate: eos {eos} ran {len(steps)} steps, want "
          f"{want_steps}")
    check(padded.shape == (QA_BATCH, QA_NEW_TOKENS) and np.array_equal(padded[:, :len(steps)],
                                                                      with_eos),
          "QA generate: the eos run's steps differ between its two routes")
    hit = 0
    for r, g in zip(padded, greedy):
        k = int(np.argmax(g == eos)) if (g == eos).any() else QA_NEW_TOKENS
        hit += k < QA_NEW_TOKENS
        check(np.array_equal(r[:k + 1], g[:k + 1]) and (r[k:] == eos).all(),
              f"QA generate: a row's eos fill is wrong (eos {eos} first at {k})")
    # the early exit: QA_BATCH copies of row 0's prompt, eos = its third token
    same = (packed.inputs_embeds[:1].expand_as(packed.inputs_embeds).contiguous(),
            packed.attention_mask[:1].expand_as(packed.attention_mask).contiguous())
    early = []
    eos0 = int(greedy[0, 2])
    k0 = int(np.argmax(greedy[0] == eos0))
    out0 = generate(ft.model, *same, temperature=0.0, eos_token_id=eos0, on_token=early.append,
                    **kw)
    check(len(early) == k0 + 1 and (out0 == greedy[0, :k0 + 1]).all(),
          f"QA generate: the early exit ran {len(early)} steps, want {k0 + 1}")

    def sampled():
        g = torch.Generator(device=dev).manual_seed(seed)
        return generate(*args, temperature=0.4, top_p=0.9, generator=g, **kw)

    t0 = time.perf_counter()
    a = sampled()
    sample_wall = time.perf_counter() - t0
    b = sampled()
    check(np.array_equal(a, b), "QA generate: two samplings from one seed differ")
    log(f"QA generate (B={QA_BATCH}, total_len {ft.cfg.total_len}, {QA_NEW_TOKENS} new "
        f"tokens): greedy {wall:.3f} s; streamed: prefill {prefill_ms:.3f} ms, decode "
        f"{decode_ms:.3f} ms/token ({len(stamps)} steps); eos {eos}: {hit} rows reach it, "
        f"{len(steps)} steps, eos-filled; {QA_BATCH} copies of row 0 with eos {eos0}: "
        f"{len(early)} steps; sampling (t 0.4, top-p 0.9) {sample_wall:.3f} s, repeatable from one "
        f"seed, {int((a != greedy).any(1).sum())} of {QA_BATCH} rows differ from greedy")
    # decode alone: a 17-token run less a 1-token run (the prefill), profiled
    short, long_ = (qa_profile(lambda n=n: generate(*args, temperature=0.0, max_new_tokens=n,
                                                    device=dev)) for n in (1, 17))
    decode = dict(wall_ms=long_["wall_ms"] - short["wall_ms"],
                  device_ms=long_["device_ms"] - short["device_ms"],
                  classes={k: v - short["classes"].get(k, 0.0)
                           for k, v in long_["classes"].items()}, top=long_["top"])
    log(qa_profile_line("QA prefill (generate of 1 token), profiled", short))
    log(qa_profile_line("QA decode, 16 steps (generate of 17 tokens less 1), profiled",
                        decode))
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms, greedy_s=wall,
                eos_steps=len(steps), sample_s=sample_wall)


def qa_top2_gap(logits) -> "np.ndarray":
    """Per row, the gap between the largest and second largest logit over
    the largest |logit|."""
    import torch

    top = torch.topk(logits.float(), 2, dim=-1).values
    return ((top[..., 0] - top[..., 1]) / logits.float().abs().amax(-1)).cpu().numpy()


def qa_step_logits(ft, packed, toks):
    """The logits that chose each of ``toks`` [B, n], by one teacher-forced
    forward over the prompt and the tokens before each."""
    import torch

    with torch.no_grad():
        t = torch.as_tensor(toks, device=packed.inputs_embeds.device)
        embeds = torch.cat([packed.inputs_embeds, ft.model.embed(t[:, :-1])], dim=1)
        mask = torch.cat([packed.attention_mask, torch.ones_like(t[:, :-1])], dim=1)
        positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
        hidden, _ = ft.model(inputs_embeds=embeds, attention_mask=mask, positions=positions,
                             return_hidden=True)
        L = packed.inputs_embeds.shape[1]
        return ft.model.apply_lm_head(hidden[:, L - 1:])


def qa_reference(table, dev, seed: int) -> None:
    """LLAMA31_8B's widths at QA_REF_LAYERS layers in fp32 (TF32 off), the
    same random weights on the card and on the CPU: the loss within 1e-5
    (relative), the trainable gradients within 1e-4 of each tensor's
    largest, and greedy generate's QA_REF_NEW_TOKENS tokens equal unless the
    CPU's top-2 logit gap at the first differing step is below 1e-4 of its
    largest logit."""
    import dataclasses

    import numpy as np
    import torch

    from medtok_tpu_torch.cli.qa import _simple_tokenize
    from medtok_tpu_torch.qa.finetune import QAFinetuneConfig, QAFinetuner, _collate_rows
    from medtok_tpu_torch.qa.llama import LLAMA31_8B, generate

    t_phase = time.perf_counter()
    llm = dataclasses.replace(LLAMA31_8B, num_layers=QA_REF_LAYERS)
    qcfg = QAFinetuneConfig(lora_rank=QA_LORA_RANK, cutoff_len=QA_REF_CUTOFF,
                            total_len=2 * QA_REF_CUTOFF, batch_size=QA_REF_BATCH, seed=seed)
    cpu = QAFinetuner(llm, table, qcfg, device="cpu")
    cpu.init_params(generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():   # nonzero lora_b, so the adapters act on the outputs
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in cpu.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=g)
    card = QAFinetuner(llm, table, qcfg, device=dev)
    card.model.load_state_dict(cpu.model.state_dict())
    card.soft_prompt.load_state_dict(cpu.soft_prompt.state_dict())
    rows = qa_rows(lambda s: _simple_tokenize(s, llm.vocab_size), QA_REF_CUTOFF, True)
    batch = _collate_rows(rows[:QA_REF_BATCH], cutoff_len=QA_REF_CUTOFF)
    losses, grads = [], []
    for ft in (cpu, card):
        loss = ft.loss_fn(batch)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu() for n, p in ft.named_parameters()
                      if p.requires_grad})
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    check(rel <= 1e-5, f"QA reference: loss {losses[1]} on the card, {losses[0]} on the CPU")
    worst = 0.0
    for n, g in grads[0].items():
        err = float((grads[1][n] - g).abs().max() / g.abs().max())
        worst = max(worst, err)
        check(err <= 1e-4, f"QA reference: gradient of {n} off by {err:.3e} of its largest")

    prompts = qa_rows(lambda s: _simple_tokenize(s, llm.vocab_size), QA_REF_CUTOFF, False)
    pb = _collate_rows(prompts[:QA_REF_BATCH], cutoff_len=QA_REF_CUTOFF)
    toks, packs = [], []
    for ft in (cpu, card):
        d = ft.device
        with torch.no_grad():
            packed = ft.soft_prompt(torch.as_tensor(pb["input_ids"], dtype=torch.long, device=d),
                                    torch.as_tensor(pb["attention_mask"], dtype=torch.long,
                                                    device=d),
                                    None, ft.model.embed, qcfg.total_len)
        packs.append(packed)
        toks.append(generate(ft.model, packed.inputs_embeds, packed.attention_mask,
                             max_new_tokens=QA_REF_NEW_TOKENS, temperature=0.0, device=d))
    gaps = qa_top2_gap(qa_step_logits(cpu, packs[0], toks[0]))    # [B, n]
    differ = np.argwhere(toks[0] != toks[1])
    if len(differ):
        row, step = (int(x) for x in differ[np.argmin(differ[:, 1])])
        gap = float(gaps[row, step])
        check(gap < 1e-4, f"QA reference: greedy tokens differ at row {row}, step {step}, where "
              f"the CPU's top-2 gap is {gap:.3e} of its largest logit")
        note = f"first differing at row {row} step {step}, top-2 gap {gap:.3e}"
    else:
        note = f"identical; smallest top-2 gap {float(gaps.min()):.3e} of the largest logit"
    log(f"QA reference (LLAMA31_8B widths, {QA_REF_LAYERS} layers, fp32, B={QA_REF_BATCH}, "
        f"cutoff {QA_REF_CUTOFF}): loss card {losses[1]:.7f} / CPU {losses[0]:.7f} (rel "
        f"{rel:.3e}); gradients within {worst:.3e} of each tensor's largest; greedy "
        f"{QA_REF_NEW_TOKENS} tokens {note}; {time.perf_counter() - t_phase:.2f} s")


def qa_cli(table, dev) -> dict:
    """python -m medtok_tpu_torch.cli.qa finetune, then eval, with --tiny on
    the fixture and a byte-level tokenizer.json written here: the
    regex-free BPE and the chat-template route."""
    import tempfile

    import numpy as np
    import torch

    from medtok_tpu_torch.qa.datasets import load_qa_rows

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        texts = [r["input"][0] for r in load_qa_rows(QA_FIXTURE)]
        j = write_tokenizer_json(root / "tokenizer.json", texts)
        n_ids = len(j["model"]["vocab"]) + len(j["added_tokens"])
        check(n_ids <= 512, f"QA CLI: the tokenizer has {n_ids} ids")
        np.save(root / "emb.npy", table[:1024])
        common = ["--data", str(QA_FIXTURE), "--embedding-path", str(root / "emb.npy"),
                  "--tiny", "--tokenizer-json", str(root / "tokenizer.json"),
                  "--adapter-path", str(root / "adapter")]
        # eval generates QA_CLI_NEW_TOKENS a question (the CLI's default is 64)
        for mode, extra in (("finetune", []),
                            ("eval", ["--max-new-tokens", str(QA_CLI_NEW_TOKENS)])):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "medtok_tpu_torch.cli.qa", mode,
                                  *common, *extra], cwd=Path(__file__).resolve().parent,
                                 capture_output=True, text=True, timeout=600)
            out[mode] = time.perf_counter() - t0
            check(run.returncode == 0, f"QA CLI {mode} failed:\n{run.stderr[-4000:]}")
            lines = run.stderr.splitlines()
            if mode == "finetune":
                losses = [float(x.rsplit(" ", 1)[1]) for x in lines if ": loss " in x]
                check(len(losses) == 200 // 16 and all(np.isfinite(losses)),
                      f"QA CLI finetune: losses {losses}")
                proj = np.load(root / "adapter" / "projector.npy")
                saved = torch.load(root / "adapter" / "lora_params.pt")
                check(proj.shape == (256, 64) and np.array_equal(
                    proj, saved["soft_prompt.projector.weight"].numpy().T),
                    f"QA CLI: projector.npy {proj.shape}")
                check(len([k for k in saved if "lora" in k]) == 2 * 2 * 2,
                      f"QA CLI: lora_params.pt holds {sorted(saved)}")
            else:
                acc = [float(x.rsplit(" ", 1)[1]) for x in lines if "Accuracy: " in x]
                check(len(acc) == 1 and 0.0 <= acc[0] <= 1.0, f"QA CLI eval: accuracy {acc}")
                out["accuracy"] = acc[0]
    log(f"QA CLI (--tiny, byte-level BPE of {n_ids} ids, {QA_TOKENIZER_MERGES} merges): "
        f"finetune {out['finetune']:.2f} s wall ({len(losses)} steps, last loss "
        f"{losses[-1]:.4f}), eval ({QA_CLI_NEW_TOKENS} new tokens) {out['eval']:.2f} s wall, "
        f"accuracy {out['accuracy']:.3f} "
        "(random weights: only its range is checked)")
    return out


def run_qa(table, dev, seed: int) -> dict:
    """Phase 17: the QA path at LLAMA31_8B width on the card (finetune,
    generate), the 2-layer card-against-CPU check and the QA CLI."""
    import dataclasses

    import torch

    from medtok_tpu_torch.cli.qa import _simple_tokenize
    from medtok_tpu_torch.qa.finetune import QAFinetuneConfig, QAFinetuner
    from medtok_tpu_torch.qa.inference import extend_with_miss_rows
    from medtok_tpu_torch.qa.llama import LLAMA31_8B

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    table = extend_with_miss_rows(table, QA_MISS_ROWS, seed=seed)
    llm = dataclasses.replace(LLAMA31_8B, remat=True)
    qcfg = QAFinetuneConfig(lora_rank=QA_LORA_RANK, cutoff_len=QA_CUTOFF, total_len=QA_TOTAL,
                            batch_size=QA_BATCH, seed=seed)
    t0 = time.perf_counter()
    ft = QAFinetuner(llm, table, qcfg, device=dev, dtype=torch.bfloat16)
    ft.init_params(generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in ft.named_parameters())
    n_train = sum(p.numel() for p in ft.trainable_parameters())
    log(f"QA model: LLAMA31_8B {n / 1e9:.3f} B parameters in bf16 ({n_train / 1e6:.3f} M "
        f"trainable in fp32), table {table.shape}, built in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")

    def tokenize(s):
        return _simple_tokenize(s, llm.vocab_size)

    for f in kernel_wrappers().values():
        f.launches = 0
        if hasattr(f, "wide_launches"):
            f.wide_launches = 0
    out = {"finetune": qa_finetune(ft, qa_rows(tokenize, QA_CUTOFF, True), dev)}
    ft.model.eval()
    out["generate"] = qa_generate(ft, qa_rows(tokenize, QA_CUTOFF, False), dev, seed)
    launches = kernel_launches()
    check(not any(launches.values()), f"QA: a kernel ran on the QA path: {launches}")
    log(f"QA: kernel launches on the finetune and generate path: {launches} (none is on it)")
    del ft
    torch.cuda.empty_cache()
    qa_reference(table, dev, seed)
    out["cli"] = qa_cli(table, dev)
    log(f"QA phase: {time.perf_counter() - t_phase:.2f} s")
    return out


# ------------------------------------------------------- EHR downstream --

EHR_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "mimic3_demo"
EHR_FIXTURE_TABLES = ("DIAGNOSES_ICD", "PROCEDURES_ICD", "PRESCRIPTIONS", "LABEVENTS",
                      "ICUSTAYS")
# the fixture's totals with every table, held to the JAX parsers on the CPU by
# tests/test_torch_ehr_parsers.py
EHR_FIXTURE_COUNTS = {"patients": 120, "visits": 427, "events": 5210}
EHR_PATIENTS = 46_520   # MIMIC-III v1.4's patients
# the patients of phase 18's grid and task builders: a tenth, so the CSVs
# they parse again take seconds, not the full set's tens of seconds each
EHR_GRID_PATIENTS = EHR_PATIENTS // 10
EHR_CLI_EPOCHS = 1
EHR_OTHER_TASKS = ("mortality", "lenofstay", "phenotype", "drugrec", "new_disease")
EXPORT_BATCH = 1024     # the export CLI's default --batch-size


def installed_version(dist: str) -> str:
    from importlib import metadata

    try:
        return metadata.version(dist)
    except metadata.PackageNotFoundError:
        return "absent"


def ehr_counts(patients: dict) -> dict:
    visits = [v for p in patients.values() for v in p]
    return {"patients": len(patients), "visits": len(visits),
            "events": sum(v.num_events for v in visits)}


def write_user_files(root: Path, dataset):
    """Phase 5's data as a user's files under ``root``: kg.csv, codes.jsonl,
    vocab.txt. Returns phase 5's DataConfig with their paths."""
    import numpy as np

    from medtok_tpu_torch.data.dataset import write_jsonl

    kg = dataset.kg
    names = np.array(sorted(kg.rel_vocab, key=kg.rel_vocab.get))
    with open(root / "kg.csv", "w") as f:
        f.write("x_index,y_index,display_relation\n")
        f.writelines(map("{},{},{}\n".format, kg.edge_src.tolist(), kg.edge_dst.tolist(),
                         names[kg.rel_index].tolist()))
    write_jsonl({"med_code": dataset.med_codes, "desc": dataset.descs,
                 "pkg_index_list": dataset.pkg_index_lists}, root / "codes.jsonl")
    vocab = dataset.tokenizer.vocab
    (root / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    return dataclasses.replace(dataset.cfg, kg_path=str(root / "kg.csv"),
                               med_codes_pkg_map_path=str(root / "codes.jsonl"),
                               text_vocab_path=str(root / "vocab.txt"))


def write_export_workdir(root: Path, model_state: dict, buffers: dict, cfg, dataset) -> Path:
    """A workdir the export CLI reads (args.json + one checkpoint) for phase
    5's model in fp32 over phase 5's data, written as a user's files:
    kg.csv, codes.jsonl, vocab.txt."""
    import torch

    from medtok_tpu_torch.config import MedTokConfig

    data = write_user_files(root, dataset)
    workdir = root / "export_workdir"
    (workdir / "checkpoints").mkdir(parents=True)
    MedTokConfig(model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                 data=data).save(workdir / "args.json")
    # the checkpoint's model and buffers (what the export reads of it)
    torch.save({"step": 0, "model": model_state, "buffers": buffers},
               workdir / "checkpoints" / "0000000.pt")
    return workdir


def run_export_routes(workdir: Path, n: int, dev) -> dict:
    """Phase 18, part 2: medtok_tpu_torch.cli.export --packed off against
    --packed on at ModelConfig() width in fp32 over phase 5's vocabulary,
    token rows by phase 5's tie-gap rule, then PretrainedMedTok on the
    unpacked files."""
    import numpy as np
    import torch

    from medtok_tpu_torch.api import PretrainedMedTok
    from medtok_tpu_torch.cli import export as export_cli
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    out = {}
    for route in ("off", "on"):
        fused_topk_l2.launches = 0
        packed_segment_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            arrays = export_cli.main(["--workdir", str(workdir), "--packed", route,
                                      "--out-dir", str(workdir / f"packed_{route}")])
        torch.cuda.synchronize()
        launches = {"topk_l2": fused_topk_l2.launches,
                    "segment_attention": packed_segment_attention.launches}
        out[route] = dict(arrays=arrays, wall_s=time.perf_counter() - t0, launches=launches,
                          export_s=export_seconds(printed.getvalue()))
        log(f"export CLI --packed {route}: {n} codes in {out[route]['wall_s']:.3f} s "
            f"({n / out[route]['wall_s']:.1f} codes/s, the CLI's reads inside; the export "
            f"alone {out[route]['export_s']:.3f} s), launches {launches}")
    batches = -(-n // EXPORT_BATCH)
    check(out["off"]["launches"] == {"topk_l2": 4 * batches, "segment_attention": 0},
          f"unpacked export: launches {out['off']['launches']}, want K1 4 x {batches} "
          "batches and no K2 (the unpacked BERT is dense)")
    check(all(v > 0 for v in out["on"]["launches"].values()),
          f"packed export: launches {out['on']['launches']}")
    got, want = out["off"]["arrays"], out["on"]["arrays"]
    check(all(np.isfinite(a).all() for a in got.values()), "unpacked export: non-finite rows")
    summary = hold_to_tie_rule(got, want, "unpacked export against the packed one")
    log(f"unpacked vs packed export (fp32, {n} codes): {summary}")
    api = PretrainedMedTok(workdir / "packed_off", workdir.parent / "codes.jsonl")
    codes = [json.loads(line)["med_code"]
             for line in open(workdir.parent / "codes.jsonl")]
    for i in (0, n // 2, n - 1):
        c = codes[i]
        i0 = codes.index(c)     # a code listed twice answers its first row
        check(api.lookup(c) == i0 and (api.embed(c) == got["embeddings_all"][i0]).all()
              and (api.tokenize(c) == got["tokens_all"][i0]).all()
              and (api.encode(c) == got["tokens_all"][i0].reshape(-1)).all(),
              f"PretrainedMedTok: {c} differs from the unpacked export's row {i0}")
    log("PretrainedMedTok on the unpacked files: 3 codes equal to their rows")
    return {route: {"wall_s": v["wall_s"], "launches": v["launches"],
                    "export_s": v["export_s"]} for route, v in out.items()}


def export_seconds(printed: str) -> float:
    """The seconds of the export alone, from the export CLI's ``exported N
    codes (...) in S s`` line."""
    m = re.search(r"^exported \d+ codes \(\w+\) in ([0-9.]+) s", printed, re.M)
    check(m is not None, f"the export CLI printed no export line:\n{printed[-2000:]}")
    return float(m.group(1))


def phenotype_index(dataset, path: Path) -> None:
    """24 labels on the KG nodes that the most vocabulary codes reach."""
    import pickle
    from collections import Counter

    freq = Counter(int(v) for nodes in dataset.pkg_index_lists for v in set(nodes))
    with open(path, "wb") as f:
        pickle.dump({label: node for label, (node, _) in enumerate(freq.most_common(24))}, f)


def run_ehr_downstream(model_state: dict, buffers: dict, cfg, dataset, table, seed: int,
                       dev, keep: Path) -> dict:
    """Phase 18: the EHR downstream entry point and the export routes that
    feed it (see the docstring)."""
    import math
    import tempfile

    import numpy as np
    import torch

    from medtok_tpu_torch.cli import ehr as ehr_cli
    from medtok_tpu_torch.ehr import CodeMapper, MIMIC3Dataset, PatientEHRTasks
    from medtok_tpu_torch.ehr.code_maps import load_code_map
    from medtok_tpu_torch.ehr.synthetic import synthetic_mimic3
    from medtok_tpu_torch.ehr.train import EHRTrainer

    t_phase = time.perf_counter()
    out = {}
    # 1. the parsers on the card's Python (they import no pandas)
    t0 = time.perf_counter()
    db = MIMIC3Dataset(EHR_FIXTURE, tables=EHR_FIXTURE_TABLES,
                       ndc_to_atc=load_code_map(EHR_FIXTURE / "ndc_to_atc.csv"))
    got = ehr_counts(db.patients)
    check(got == EHR_FIXTURE_COUNTS, f"EHR parsers on the demo fixture: {got} != "
          f"{EHR_FIXTURE_COUNTS}")
    log(f"EHR parsers on tests/fixtures/mimic3_demo, every table: {got} in "
        f"{time.perf_counter() - t0:.3f} s; packages on this machine (the path uses none): "
        + ", ".join(f"{name} {installed_version(name)}"
                    for name in ("pandas", "pyarrow", "scikit-learn", "python-dateutil",
                                 "wandb")))

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        n = len(dataset)
        # 2. the unpacked export against the packed one, then PretrainedMedTok
        t0 = time.perf_counter()
        # the export files and workdir stay under keep for phase 23
        files = keep / "export"
        files.mkdir()
        workdir = write_export_workdir(files, model_state, buffers, cfg, dataset)
        log(f"export files: kg.csv of {len(dataset.kg.edge_src)} edges, codes.jsonl of {n} "
            f"codes, an fp32 workdir, written in {time.perf_counter() - t0:.2f} s")
        out["export"] = run_export_routes(workdir, n, dev)
        out["export"]["workdir"] = workdir

        # 3. the EHR CLI at EHRTrainConfig() width on MIMIC-III-schema CSVs
        ehr_root = root / "EHR"
        t0 = time.perf_counter()
        synthetic_mimic3(ehr_root / "MIMIC_III", dataset.med_codes, num_patients=EHR_PATIENTS,
                         seed=seed, v14_rates=True)
        np.save(root / "embeddings_all.npy", table)
        write_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in (ehr_root / "MIMIC_III").iterdir())
        rows = {f.stem: sum(1 for _ in open(f)) - 1
                for f in sorted((ehr_root / "MIMIC_III").iterdir())}
        log(f"EHR data: synthetic_mimic3 of {EHR_PATIENTS} patients at MIMIC-III v1.4's "
            f"rows an admission ({rows}) over the {n}-code "
            f"vocabulary, {size} bytes of CSV, written in {write_s:.2f} s")
        common = ["--dataset", "MIMIC_III", "--task", "readmission", "--ehr-root",
                  str(ehr_root), "--med-codes", str(files / "codes.jsonl"),
                  "--embedding-path", str(root / "embeddings_all.npy")]
        for f in kernel_wrappers().values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ehr_cli.main([*common, "--epochs", str(EHR_CLI_EPOCHS),
                            "--save-result-path", str(root / "res")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        k3 = {k: launches[f"flash_attention_{k}"] for k in ("fwd", "dq", "dkv")}
        check(all(v > 0 for v in k3.values()), f"cli.ehr: a K3 kernel never ran: {k3}")
        check(launches["topk_l2"] == launches["segment_attention"] == 0,
              f"cli.ehr: launches {launches}")
        tm = json.loads((root / "res" / "test_metrics.json").read_text())
        check(all(math.isfinite(tm["test"][k]) and 0.0 <= tm["test"][k] <= 1.0
                  for k in ("auc", "aupr", "f1")), f"cli.ehr: test metrics {tm['test']}")
        st = res["stages"]
        valid = float(np.mean([1.0 - b.pad_mask.mean() for b in res["test_batches"]]))
        log(f"cli.ehr readmission: {valid:.4f} of the {res['test_batches'][0].pad_mask.shape[1]} "
            "code slots of a test sample hold a code")
        log(f"cli.ehr readmission (EHRTrainConfig() width, {EHR_CLI_EPOCHS} epochs): "
            f"{wall:.3f} s wall; stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items() if k.endswith("_s"))
            + f"; fit {st['fit_samples']} samples, {st['fit_samples'] / st['fit_s']:.1f} "
            f"samples/s (validation and host batches inside); K3 launches {k3}; "
            f"best val {tm['best_val']}; test {tm['test']}")
        trainer = EHRTrainer.load(root / "res" / "best_model", table, device=dev)
        again = trainer.evaluate(res["test_batches"])
        err = max(abs(again[k] - tm["test"][k]) for k in ("auc", "aupr", "f1"))
        check(err <= 1e-6, f"cli.ehr: the reloaded best_model gives {again}, the CLI "
              f"{tm['test']}")
        log(f"cli.ehr best_model reloaded: test metrics reproduced (max diff {err:.3e})")
        del trainer
        out["cli"] = dict(wall_s=wall, stages=st, k3=k3, test=tm["test"])

        # 4. a 2-point grid, and the other five task builders, on a tenth
        small_root = root / "EHR_small"
        synthetic_mimic3(small_root / "MIMIC_III", dataset.med_codes,
                         num_patients=EHR_GRID_PATIENTS, seed=seed, v14_rates=True)
        small = [str(small_root) if a == str(ehr_root) else a for a in common]
        t0 = time.perf_counter()
        grid = ehr_cli.main([*small, "--epochs", "1", "--hyper-search", "--search-grid",
                             '{"dropout": [0.1, 0.5]}', "--save-result-path",
                             str(root / "grid")])
        hs = json.loads((root / "grid" / "hyper_search.json").read_text())
        auprs = [r["best_val"]["aupr"] for r in hs["results"]]
        check(len(auprs) == 2 and auprs == sorted(auprs, reverse=True),
              f"cli.ehr --hyper-search: {hs['results']}")
        log(f"cli.ehr --hyper-search (dropout 0.1 / 0.5, 1 epoch, {EHR_GRID_PATIENTS} "
            "patients): "
            f"{time.perf_counter() - t0:.3f} s, val aupr {auprs}, stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in grid["stages"].items() if k.endswith("_s")))
        phenotype_index(dataset, root / "phenotype_index.pkl")
        t0 = time.perf_counter()
        patients = MIMIC3Dataset(small_root / "MIMIC_III").patients
        mapper = CodeMapper(files / "codes.jsonl")
        counts = {"parse_s": time.perf_counter() - t0}
        for task in EHR_OTHER_TASKS:
            t0 = time.perf_counter()
            data = PatientEHRTasks(patients, mapper,
                                   phenotype_index=root / "phenotype_index.pkl").build(task)
            counts[task] = (len(data), sum(len(d) for d in data),
                            round(time.perf_counter() - t0, 3))
        check(all(counts[t][0] > 0 for t in ("mortality", "lenofstay", "new_disease")),
              f"EHR tasks: {counts}")
        log(f"EHR task builders over {EHR_GRID_PATIENTS} patients (patients, samples, s): "
            f"{counts}")
        out["tasks"] = counts
    log(f"EHR downstream phase: {time.perf_counter() - t_phase:.2f} s")
    return out


# ---------------------------------------------------------- host runtime --

HOST_CODES = 600_000    # the real vocabulary's size (SURVEY)
FENCE_PACKS = 24        # packs of the fence witness, each queued behind a stall
FENCE_SHAPES = (8, 512, 8192)   # (Lt, Ln, Epg) of the witness: the stream encoding


def check_wordpiece(dataset) -> None:
    """NativeWordPiece's ids equal the Python tokenizer's for every
    description of the vocabulary; both timed."""
    import numpy as np

    from medtok_tpu_torch.data.native_text import NativeWordPiece

    tok, max_len = dataset.tokenizer, dataset.cfg.max_text_length
    descs = [str(d) for d in dataset.descs]
    native = NativeWordPiece(tok)
    t0 = time.perf_counter()
    out, lens = native.encode_batch_flat(descs, max_length=max_len)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [tok.encode(d, max_length=max_len)[0] for d in descs]
    python_s = time.perf_counter() - t0
    bad = [i for i, w in enumerate(want)
           if lens[i] != len(w) or not np.array_equal(out[i, :lens[i]], w)]
    check(not bad, f"host runtime: NativeWordPiece differs from the Python tokenizer on "
          f"{len(bad)} descriptions, first {bad[:5]}")
    log(f"host runtime: NativeWordPiece ids equal the Python tokenizer's for all "
        f"{len(descs)} descriptions ({int(lens.sum())} ids); native {native_s:.4f} s "
        f"({len(descs) / native_s:.0f} texts/s), Python {python_s:.3f} s "
        f"({len(descs) / python_s:.0f} texts/s)")


def same_graphs(got, want, label: str) -> None:
    """A native-route batch (an unpacked compact batch on the card, or a
    host one) against a numpy-route batch, graph by graph: node ids, then
    each graph's clean edge list in slot order, the padding trimmed (the
    routes' edge buckets may differ)."""
    import numpy as np

    g, w = ({k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in b._asdict().items()}
            for b in (got, want))
    B = w["node_ids"].shape[0]
    nn = g["node_mask"].sum(1)
    check(np.array_equal(nn, w["node_mask"].sum(1)), f"{label}: node counts differ")
    ln = min(g["node_ids"].shape[1], w["node_ids"].shape[1])
    check(int(nn.max(initial=0)) <= ln, f"{label}: a graph overflows the narrower node bucket")
    keep = np.arange(ln)[None, :] < nn[:, None]
    check(np.array_equal(g["node_ids"][:, :ln][keep], w["node_ids"][:, :ln][keep]),
          f"{label}: node ids differ")
    ne = (g["edge_weight"].reshape(B, -1) > 0).sum(1)
    check(np.array_equal(ne, (w["edge_weight"].reshape(B, -1) > 0).sum(1)),
          f"{label}: edge counts differ")
    m = min(g["edge_weight"].size, w["edge_weight"].size) // B
    valid = np.arange(m)[None, :] < ne[:, None]
    for name in ("edge_src", "edge_dst"):
        check(np.array_equal(g[name].reshape(B, -1)[:, :m][valid],
                             w[name].reshape(B, -1)[:, :m][valid]), f"{label}: {name} differs")


def encoding_of(cb) -> str:
    import torch

    if cb.outdeg is not None:
        return "stream"
    return "uint16" if cb.edge_packed.dtype == torch.int16 else "int32"


def check_group_packs(dataset, dataset_np, dev) -> None:
    """Every export group's compact batch (pinned pool, copied, fenced,
    unpacked on the card) against the numpy route graph by graph; then one
    group forced into the 16-node bucket (uint16 pairs) and one 512-node
    group with the stream threshold lifted (int32 pairs)."""
    import numpy as np

    from medtok_tpu_torch.data import dataset as dataset_module
    from medtok_tpu_torch.data.compact import unpack_compact
    from medtok_tpu_torch.export import code_buckets, export_groups

    buckets = code_buckets(len(dataset))
    seen: dict[str, int] = {}
    tail = None

    def one(codes, label, shapes=None):
        cb, fence = dataset.make_batch_compact(codes, force_shapes=shapes, want_text=False,
                                               pinned=True)
        dcb = cb.to(dev)
        fence.set_fence(dev)
        got = unpack_compact(dcb)
        same_graphs(got, dataset_np.make_batch(codes, force_shapes=shapes), label)
        enc = encoding_of(dcb)
        seen[enc] = seen.get(enc, 0) + 1
        return got.node_ids.shape[1]

    groups = export_groups(dataset)
    t0 = time.perf_counter()
    for gi, group in enumerate(groups):
        C = next((c for c in buckets if len(group) <= c), buckets[-1])
        codes = np.concatenate([group, np.repeat(group[-1:], C - len(group))]).tolist()
        if one(codes, f"group {gi}") == max(dataset.cfg.node_buckets):
            tail = codes
    check(tail is not None, "host runtime: no export group in the largest node bucket")
    lt = dataset.batch_shapes(tail)[0]
    small = (lt, dataset.cfg.node_buckets[0], dataset.cfg.edge_buckets[0])
    one(tail, f"tail group forced to {small}", shapes=small)
    stream_min = dataset_module.STREAM_MIN_NODES
    dataset_module.STREAM_MIN_NODES = 1 << 30
    try:
        one(tail, "tail group, int32 pairs")
    finally:
        dataset_module.STREAM_MIN_NODES = stream_min
    check(set(seen) == {"uint16", "int32", "stream"},
          f"host runtime: encodings run {seen}, want uint16, int32 and stream")
    log(f"host runtime: {len(groups)} export groups + 2 forced ones, compact batches "
        f"unpacked on the card equal the numpy route graph by graph "
        f"({time.perf_counter() - t0:.2f} s); encodings {seen}")


def fence_run(dataset, dev, rows, fenced: bool) -> int:
    """FENCE_PACKS packs into a pool of depth 1, each copy queued behind a
    matmul stall so that the next pack comes while it is in flight; returns
    how many device batches differ from a fresh host pack of their rows."""
    import os

    import numpy as np
    import torch

    from medtok_tpu_torch.data.compact import unpack_compact

    stall = torch.randn(4096, 4096, device=dev)
    depth_cap = os.environ.get("MEDTOK_POOL_DEPTH_CAP")
    os.environ["MEDTOK_POOL_DEPTH_CAP"] = "1"
    dataset.native._pools.clear()
    dataset.native._pool_next.clear()
    sent = []
    try:
        torch.cuda.synchronize()
        for i in range(FENCE_PACKS):
            for _ in range(8):
                stall = torch.tanh(stall @ stall)
            codes = rows[i % len(rows)]
            cb, fence = dataset.make_batch_compact(codes, force_shapes=FENCE_SHAPES,
                                                   want_text=False, pinned=True)
            sent.append((codes, cb.to(dev)))
            if fenced:
                fence.set_fence(dev)
        torch.cuda.synchronize()
    finally:
        if depth_cap is None:
            del os.environ["MEDTOK_POOL_DEPTH_CAP"]
        else:
            os.environ["MEDTOK_POOL_DEPTH_CAP"] = depth_cap
    check(len(dataset.native._pools) == 1
          and len(next(iter(dataset.native._pools.values()))) == 1,
          "host runtime: the witness's pool is not one entry deep")
    differ = 0
    for codes, dcb in sent:
        got, want = unpack_compact(dcb), dataset.make_batch(codes, force_shapes=FENCE_SHAPES)
        differ += not all(np.array_equal(g.cpu().numpy(), np.asarray(w))
                          for g, w in zip(got[2:], want[2:]))
    return differ


def check_fence(dataset, dev) -> None:
    """The fence witness: a pool of depth 1, many packs while earlier copies
    are in flight, each device batch held to a fresh host pack. Then the
    same run without fences, to show the witness sees what a missing fence
    does (logged, not a failure)."""
    import numpy as np

    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.utils.profiling import counters

    fresh = MedCodeDataset(dataset.kg, dataset.med_codes, dataset.descs,
                           dataset.pkg_index_lists, dataset.tokenizer, cfg=dataset.cfg)
    fresh.warm_cache(tokenize=False)
    sizes = fresh.node_counts(0, len(fresh))
    heavy = np.argsort(-sizes, kind="stable")
    rows = [heavy[np.arange(i, i + 512 * 8, 8) % len(heavy)].tolist() for i in range(6)]
    wait0 = counters().get("native.fence_wait_s", 0)
    t0 = time.perf_counter()
    differ = fence_run(fresh, dev, rows, fenced=True)
    wall = time.perf_counter() - t0
    waited = counters().get("native.fence_wait_s", 0) - wait0
    check(differ == 0, f"host runtime: {differ} of {FENCE_PACKS} fenced device batches differ "
          "from their host packs")
    check(waited > 0, "host runtime: no pack waited on a fence (no copy was in flight)")
    unfenced = fence_run(fresh, dev, rows, fenced=False)
    log(f"host runtime: fence witness, {FENCE_PACKS} packs of {FENCE_SHAPES} into one pinned "
        f"entry, copies queued behind a stall: all device batches equal their host packs, "
        f"{waited:.3f} s of {wall:.3f} s waiting on fences; without fences {unfenced} of "
        f"{FENCE_PACKS} differ")


def host_half(dataset, seed: int) -> None:
    """The export's host half at HOST_CODES synthetic codes on phase 5's
    KG: the vocabulary's node arena and WordPiece (warm_cache), then every
    group's text rows and compact pack into pinned pools; no model, no
    copy."""
    import numpy as np

    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.synthetic import synthetic_vocab_columns
    from medtok_tpu_torch.export import code_buckets, export_groups, packed_layout

    t0 = time.perf_counter()
    cols = synthetic_vocab_columns(np.random.default_rng(seed + 19), num_codes=HOST_CODES,
                                   num_kg_nodes=dataset.kg.num_nodes, heavy_tail=True)
    big = MedCodeDataset.from_columns(dataset.kg, cols, dataset.tokenizer, cfg=dataset.cfg)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big.warm_cache(tokenize=True)
    warm_s = time.perf_counter() - t0
    row_len, num_rows, _ = packed_layout(big)
    buckets = code_buckets(len(big))
    t0 = time.perf_counter()
    groups = export_groups(big)
    text_s = pack_s = 0.0
    for group in groups:
        C = next((c for c in buckets if len(group) <= c), buckets[-1])
        codes = np.concatenate([group, np.repeat(group[-1:], C - len(group))])
        t1 = time.perf_counter()
        big.pack_text_rows(group, row_len=row_len, num_rows=num_rows)
        t2 = time.perf_counter()
        big.make_batch_compact(codes.tolist(), want_text=False, pinned=True)
        t3 = time.perf_counter()
        text_s += t2 - t1
        pack_s += t3 - t2
    groups_s = time.perf_counter() - t0
    total = warm_s + groups_s
    pinned = big.native.pool_bytes(pinned=True)
    log(f"host runtime: export host half at {HOST_CODES} synthetic codes (vocabulary made in "
        f"{made_s:.2f} s, not counted): warm_cache {warm_s:.3f} s (arena + WordPiece), "
        f"{len(groups)} groups {groups_s:.3f} s (text rows {text_s:.3f}, compact packs "
        f"{pack_s:.3f}); {total:.3f} s, {HOST_CODES / total:.1f} codes/s; "
        f"{pinned / 2**20:.1f} MiB pinned in {len(big.native._pools)} pools")


def run_host_runtime(dataset, dataset_np, dev, seed: int) -> None:
    """Phase 19: the host data runtime."""
    phase_t0 = time.perf_counter()
    check_wordpiece(dataset)
    check_group_packs(dataset, dataset_np, dev)
    check_fence(dataset, dev)
    host_half(dataset, seed)
    log(f"host runtime: phase {time.perf_counter() - phase_t0:.2f} s")


# ------------------------------------------------------ training variants --

VARIANT_STEPS = 4       # cli.train steps of the GAT + kmeans + revival run
DROPOUT_STEPS = 2       # cli.train steps of the text-dropout run
VARIANT_REF_STEPS = 3   # card-against-CPU steps of the small fp32 variant
VARIANT_REF_CODES = 64  # codes a batch of the small fp32 variant
# rows the small fp32 variant starts dead (the others at the share 1 / C): a
# row revived twice toward one feature lands within about 1e-6 of the other
# rows revived twice toward it, where a card / CPU rounding difference may
# pick either, so only a few rows start dead (tests/test_torch_train_variants.py)
VARIANT_REVIVED = (3, 17, 40, 71, 88)
KMEANS_SAMPLES = 2 * TRAIN_BATCH   # the init's rows at batch 1024: text and graph


def variant_model_config():
    """The verify recipe's widths with the GAT encoder and the EMA codebook
    (+ revival), fp32, cross-attention dropout 0."""
    from medtok_tpu_torch.config import (
        GraphEncoderConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
    )

    return ModelConfig(
        text=TextEncoderConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
        graph=GraphEncoderConfig(model_name="GAT", in_channels=8, hidden_channels=16,
                                 out_channels=16),
        quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16,
                                  cross_attn_dropout=0.0, use_kmeans=True,
                                  codebook_revival=True),
        compute_dtype="float32")


def check_variant_reference(dataset, dev) -> None:
    """Three packed fp32 steps of a GAT + kmeans + revival model at the
    verify recipe's widths, kernels on the card against the plain versions
    on the CPU (the EMA codebook random unit rows, the VARIANT_REVIVED rows
    dead), each step from the CPU's state after the one before: loss terms
    within 1e-5 relative (or 2e-6 absolute, an InfoNCE term being a
    difference of values near 14); every trainable tensor and the EMA
    buffers within 1e-5 of the tensor's largest, the usage FIFO equal.
    Elements whose gradient is below 1e-6 of its tensor's largest on both
    sides, and not 0 on both (rounding noise: the key biases, whose exact
    gradient is 0, measured against the key weight's, and conv2.att_dst
    where its shift cancels), are set aside and counted: Adam moves them by
    about lr either way. Then
    the trained model's fp32 export, card against CPU, by phase 5's tie-gap
    rule."""
    import torch

    from medtok_tpu_torch.config import MedTokConfig, TrainConfig
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.train.trainer import Trainer, trainable_parameters
    from medtok_tpu_torch.utils.checkpoint import load_weights

    t0 = time.perf_counter()
    cfg = MedTokConfig(model=variant_model_config(), data=dataset.cfg,
                       train=TrainConfig(packed_text=True, global_batch_size=VARIANT_REF_CODES,
                                         lr=1e-3, max_grad_norm=0.5))
    cpu = Trainer(cfg, device="cpu")
    card = Trainer(cfg, device=dev)
    cpu_state, card_state = cpu.init_state(), card.init_state()
    q = cpu.model.quantize
    C = q.cfg.codebook_size
    x = torch.randn(q.ema_codebook.shape, generator=torch.Generator().manual_seed(7))
    q.ema_codebook = x / x.norm(dim=-1, keepdim=True)
    q.ema_embed_prob = torch.full((C,), 1.0 / C).index_fill_(
        0, torch.tensor(VARIANT_REVIVED), 0.0)
    start = q.ema_codebook.clone()
    batches = [dataset.make_batch(list(range(i * VARIANT_REF_CODES,
                                             (i + 1) * VARIANT_REF_CODES)), aug_seed=i + 1)
               for i in range(VARIANT_REF_STEPS)]
    card_params = dict(trainable_parameters(card.model))
    loss_err = param_err = buf_err = 0.0
    set_aside = {}
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    for b in batches:
        # each step starts the card from the CPU's state: the CPU's own
        # scatter-adds (index_put_ with atomics) round in a varying order, and
        # Adam's first steps move a noise-gradient element by about lr either
        # way, so two runs drift apart over steps; one step at a time holds
        # each step's computation
        sd = cpu.model.state_dict()
        load_weights(card.model, {"model": sd, "buffers": {
            n: t for n, t in cpu.model.named_buffers() if n not in sd}})
        card_state.opt_state.count = cpu_state.opt_state.count
        with torch.no_grad():
            for dst, src in ((card_state.opt_state.mu, cpu_state.opt_state.mu),
                             (card_state.opt_state.nu, cpu_state.opt_state.nu)):
                for d, t in zip(dst, src):
                    d.copy_(t)
        cpu_state, m_cpu = cpu.step_fn(cpu_state, b.to("cpu"), cpu.pack(b).to("cpu"))
        card_state, m_card = card.step_fn(card_state, b.to(dev), card.pack(b).to(dev))
        # within 1e-5 relative, or 2e-6 absolute: an InfoNCE term is the
        # difference of two values near 1 / 0.07, whose fp32 ulp is ~1e-6
        for k, v in m_cpu.items():
            x, y = float(m_card[k]), float(v)
            check(abs(x - y) <= max(1e-5 * abs(y), 2e-6),
                  f"variant reference: {k} {x} on the card, {y} on the CPU")
            loss_err = max(loss_err, abs(x - y) / max(abs(y), 1e-6))
        grads = {name: p.grad.abs() for name, p in trainable_parameters(cpu.model)}
        for name, p in trainable_parameters(cpu.model):
            # the key bias's exact gradient is 0: its noise is measured
            # against the key weight's gradient. An element is noise when
            # both sides' gradients are below 1e-6 of the largest and not
            # both exactly 0 (rows of nodes no graph holds stay 0 on both)
            a, b = grads[name], card_params[name].grad.abs().cpu()
            ref = grads[name.replace("bias", "weight")] if name.endswith("k_proj.bias") else a
            small = 1e-6 * ref.max()
            keep = ~((a < small) & (b < small) & ((a > 0) | (b > 0)))
            set_aside[name] = set_aside.get(name, 0) + int((~keep).sum())
            diff = (card_params[name].detach().cpu() - p.detach()).abs()[keep]
            if diff.numel():
                param_err = max(param_err, float(diff.max() / p.detach().abs().max()))
        qc = card.model.quantize
        buf_err = max(buf_err, *(float((getattr(qc, k).cpu() - getattr(q, k)).abs().max()
                                       / getattr(q, k).abs().max())
                                 for k in ("ema_codebook", "ema_cluster", "ema_embed_prob")))
        check(torch.equal(qc.codebook_used.cpu(), q.codebook_used),
              "variant reference: the usage FIFO differs")
    launches = {"topk_l2": fused_topk_l2.launches,
                "segment_attention": packed_segment_attention.launches}
    want = {"topk_l2": TRAIN_SWEEPS * VARIANT_REF_STEPS,
            "segment_attention": 2 * VARIANT_REF_STEPS}
    check(launches == want, f"variant reference: launches {launches} != {want}")
    check(param_err <= 1e-5, f"variant reference: parameters off by {param_err:.3e}")
    check(buf_err <= 1e-5, f"variant reference: EMA buffers off by {buf_err:.3e}")
    set_aside = {k: v for k, v in set_aside.items() if v}
    revived = set(torch.nonzero((q.ema_codebook - start).norm(dim=-1) > 0.5)
                  .flatten().tolist())
    check(bool(revived) and revived <= set(VARIANT_REVIVED),
          f"variant reference: revived rows {revived}")
    log(f"variant reference (GAT + kmeans + revival, verify-recipe widths, fp32, "
        f"{VARIANT_REF_STEPS} packed steps of {VARIANT_REF_CODES} codes, card vs CPU): loss "
        f"terms within {loss_err:.3e} relative, parameters within {param_err:.3e} of each tensor's "
        f"largest ({sum(set_aside.values())} noise elements set aside: {set_aside}), EMA "
        f"buffers within {buf_err:.3e}, usage FIFO equal; rows {sorted(revived)} revived; "
        f"launches {launches}; {time.perf_counter() - t0:.2f} s")
    check_reference(card.model, dataset, dev,
                    label="GAT + kmeans + revival after 3 steps, fp32")


def check_kmeans_full(dev) -> dict:
    """The k-means init at ModelConfig() and batch 1024: KMEANS_SAMPLES unit
    rows against 21000 means drawn with replacement (so duplicated). The
    first product's duplicated columns must be bit-identical on the card
    (else an exact tie breaks another way than on the CPU) and the first
    assignments equal the CPU's; after 10 iterations the means are within
    1e-6 of the CPU's and each sample's rows (those drawn as its copies)
    hold the CPU's counts. Returns the card's and the CPU's times."""
    import torch

    from medtok_tpu_torch.config import QuantizerConfig
    from medtok_tpu_torch.ops.ema import kmeans, kmeans_init_indices
    from medtok_tpu_torch.ops.vq import l2_normalize

    qc = QuantizerConfig()
    C, D = qc.codebook_size, qc.codebook_embed_dim
    samples = l2_normalize(torch.randn(KMEANS_SAMPLES, D,
                                       generator=torch.Generator().manual_seed(20)))
    idx = kmeans_init_indices(KMEANS_SAMPLES, C)
    first = torch.full((KMEANS_SAMPLES,), -1, dtype=torch.long)
    for j, i in enumerate(idx.tolist()):       # each column's first copy
        if first[i] < 0:
            first[i] = j
    first_col = first[idx].to(dev)
    s_dev = samples.to(dev)
    sims = s_dev @ s_dev[idx.to(dev)].T
    dup = int((first_col != torch.arange(C, device=dev)).sum())
    check(torch.equal(sims, sims[:, first_col]),
          "kmeans: duplicated means' columns of the card's product differ")
    assign = torch.argmax(sims, dim=-1).cpu()
    check(torch.equal(assign, torch.argmax(samples @ samples[idx].T, dim=-1)),
          "kmeans: the first assignments differ from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means, bins = kmeans(s_dev, C, 10, True, init_idx=idx)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_means, cpu_bins = kmeans(samples, C, 10, True, init_idx=idx)
    cpu_s = time.perf_counter() - t0
    # from the second iteration a sample meets its cluster's re-normalised
    # mean and the untouched copies of itself, equal but for the last bit:
    # which one wins turns on rounding, so the bins are held per sample (the
    # rows that started as its copies), the means row by row
    bins = bins.cpu()
    per_sample = [torch.zeros(KMEANS_SAMPLES).index_add_(0, idx, b) for b in (bins, cpu_bins)]
    check(torch.equal(*per_sample), "kmeans: a sample's rows hold other counts than on the CPU")
    err = float((means.cpu() - cpu_means).abs().max())
    check(err <= 1e-6, f"kmeans: means off by {err:.3e}")
    log(f"kmeans ({KMEANS_SAMPLES} x {C} x {D}, cosine, 10 iterations; {dup} of the {C} "
        f"means are duplicates): duplicated columns bit-identical on the card, first "
        f"assignments equal to the CPU's; final bins equal per sample's rows "
        f"({int((bins != cpu_bins).sum())} rows differ, each between copies of one sample), "
        f"means within {err:.3e}; card {1e3 * card_s:.3f} ms, CPU {1e3 * cpu_s:.3f} ms")
    return dict(card_ms=1e3 * card_s, cpu_ms=1e3 * cpu_s)


def variant_cli_run(label: str, argv: list, want: dict) -> tuple[Path, dict]:
    """One cli.train run in this process: its wall, peak memory, launches
    (K1 and K2 counted from 0), and the step times from metrics.jsonl
    (steps_per_sec of each step past the first: batch build, pack, copies
    and step)."""
    import numpy as np
    import torch

    from medtok_tpu_torch.cli import train as train_cli
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    workdir = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"topk_l2": fused_topk_l2.launches,
                "segment_attention": packed_segment_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == want, f"{label}: launches {launches} != {want}")
    metrics = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          f"{label}: non-finite metrics {metrics}")
    step_ms = [1e3 / m["steps_per_sec"] for m in metrics[1:]]
    run = dict(wall_s=wall, peak_gib=peak, launches=launches, step_ms=float(np.mean(step_ms)),
               codes_per_s=TRAIN_BATCH * 1e3 / float(np.mean(step_ms)), losses=losses)
    log(f"{label}: {len(metrics)} steps at batch {TRAIN_BATCH}, {wall:.3f} s wall (the "
        f"CLI's reads and save inside); steps past the first {[round(v, 3) for v in step_ms]} "
        f"ms: {run['step_ms']:.3f} ms/step, {run['codes_per_s']:.1f} codes/s (batch build, "
        f"pack, copies, step); peak {peak:.2f} GiB; launches {launches}; losses "
        f"{[round(v, 4) for v in losses]}")
    return workdir, run


def run_variant_clis(dataset, dev, gen) -> dict:
    """(a) cli.train --graph-model-name GAT --kmeans --codebook-revival at
    ModelConfig() width (bf16, packed, batch 1024) for VARIANT_STEPS steps
    over phase 5's data as a user's files, then cli.export --workdir of it
    over the same codes; (b) cli.train --text-dropout-in-train (GCN,
    unpacked) for DROPOUT_STEPS steps. K1 on the first step's six sweeps
    (the k-means-initialised EMA codebook, duplicated rows and all) and K2
    on the export's first packing are held to their plain versions."""
    import tempfile

    import numpy as np
    import torch

    from medtok_tpu_torch.api import MedTok
    from medtok_tpu_torch.cli import export as export_cli
    from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.models import bert
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager

    out = {}
    n = len(dataset)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = write_user_files(root, dataset)
        log(f"variant CLI files: phase 5's {n} codes and {len(dataset.kg.edge_src)} KG edges "
            f"written in {time.perf_counter() - t0:.2f} s")
        common = ["--kg-path", data.kg_path, "--med-codes-pkg-map-path",
                  data.med_codes_pkg_map_path, "--text-vocab", data.text_vocab_path,
                  "--global-batch-size", str(TRAIN_BATCH), "--epochs", "1",
                  "--ckpt-every", "1000"]
        # (a), recording the first step's K1 inputs
        k1_inputs = []
        distance_topk = vq.distance_topk

        def recorded(z_n, e_n, k, **kw):
            if len(k1_inputs) < TRAIN_SWEEPS:
                k1_inputs.append((z_n.detach(), e_n.detach(), k))
            return distance_topk(z_n, e_n, k, **kw)

        vq.distance_topk = recorded
        try:
            workdir, out["train"] = variant_cli_run(
                "cli.train GAT + kmeans + revival", [
                    *common, "--results-dir", str(root / "a"), "--graph-model-name", "GAT",
                    "--kmeans", "--codebook-revival", "--max-steps", str(VARIANT_STEPS)],
                {"topk_l2": TRAIN_SWEEPS * VARIANT_STEPS,
                 "segment_attention": 12 * VARIANT_STEPS})
        finally:
            vq.distance_topk = distance_topk
        check("kmeans codebook init done" in (workdir / "log.txt").read_text(),
              "cli.train --kmeans: no k-means init at step 0")
        ck = CheckpointManager(workdir).load()
        check("quantize.codebook" not in ck["model"]
              and {"quantize.ema_codebook", "quantize.ema_embed_prob"} <= set(ck["buffers"]),
              "cli.train --kmeans: the checkpoint lacks the EMA codebook")
        cb = ck["buffers"]["quantize.ema_codebook"].float().cpu()
        check(bool(torch.isfinite(cb).all())
              and float((cb.norm(dim=-1) - 1).abs().max()) < 1e-4,
              "cli.train --kmeans: the EMA codebook's rows are not unit rows")
        for i, (z, e, k) in enumerate(k1_inputs):
            check_k1_case(z, e, f"GAT + kmeans training sweep {i}", k=k)
        # the export of that workdir, recording its first K2 packing
        segs = []

        def seg_recorded(q, k, v, seg, **kw):
            if not segs:
                segs.append(seg.detach())
            return packed_segment_attention(q, k, v, seg, **kw)

        fused_topk_l2.launches = 0
        packed_segment_attention.launches = 0
        bert.packed_segment_attention = seg_recorded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            arrays = export_cli.main(["--workdir", str(workdir)])
        finally:
            bert.packed_segment_attention = packed_segment_attention
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"topk_l2": fused_topk_l2.launches,
                    "segment_attention": packed_segment_attention.launches}
        check(all(v > 0 for v in launches.values()), f"variant export: launches {launches}")
        emb, tok = arrays["embeddings_all"], arrays["tokens_all"]
        check(emb.shape == (n, 4 * D) and np.isfinite(emb).all()
              and tok.min() >= 0 and tok.max() < 21000,
              f"variant export: embeddings {emb.shape}, tokens in [{tok.min()}, {tok.max()}]")
        out["export"] = dict(wall_s=wall, launches=launches)
        log(f"cli.export --workdir of the GAT + kmeans run: {n} codes in {wall:.3f} s "
            f"({n / wall:.1f} codes/s, the CLI's reads inside), launches {launches}; "
            f"{len(np.unique(tok[:, 2:]))} distinct shared tokens")
        seg = segs[0]
        check_segment_case(gen, dev, seg, False,
                           f"cli.export packing [{seg.shape[0]}, {seg.shape[1]}]")
        cfg = CheckpointManager.load_config(workdir)
        ds = MedCodeDataset.from_path(
            KnowledgeGraph.from_csv(cfg.data.kg_path), cfg.data.med_codes_pkg_map_path,
            WordPieceTokenizer.from_vocab_file(cfg.data.text_vocab_path), cfg=cfg.data)
        first = next(epoch_batches(ds, batch_size=TRAIN_BATCH, seed=cfg.train.global_seed))
        log(f"variant CLIs: the CLI's DataConfig buckets (text {cfg.data.text_buckets}, nodes "
            f"{cfg.data.node_buckets}, edges {cfg.data.edge_buckets}); the first training "
            f"batch's (Lt, Ln, Epg) = ({first.input_ids.shape[1]}, {first.node_ids.shape[1]}, "
            f"{first.edge_src.shape[0] // TRAIN_BATCH}), "
            f"{int(np.asarray(first.attention_mask).sum())} text tokens of "
            f"{first.input_ids.size} slots")
        api = MedTok.from_checkpoint(workdir, ds, device=dev)
        check(torch.equal(api.model.quantize.ema_codebook.cpu(), cb),
              "MedTok.from_checkpoint: the EMA codebook differs from the checkpoint's")
        got = api.tokenize_batch(ds.med_codes[:3])
        check(np.isfinite(got.embedding).all(), "MedTok.from_checkpoint: non-finite rows")
        log("MedTok.from_checkpoint of the GAT + kmeans run: the EMA codebook restored bit "
            "for bit, 3 codes tokenized")
        del api
        # (b)
        _, out["dropout"] = variant_cli_run(
            "cli.train --text-dropout-in-train", [
                *common, "--results-dir", str(root / "b"), "--text-dropout-in-train",
                "--max-steps", str(DROPOUT_STEPS)],
            {"topk_l2": TRAIN_SWEEPS * DROPOUT_STEPS, "segment_attention": 0})
    return out


def run_training_variants(dataset, dev, gen) -> dict:
    """Phase 20: the training variants."""
    phase_t0 = time.perf_counter()
    check_variant_reference(dataset, dev)
    kmeans_times = check_kmeans_full(dev)
    out = run_variant_clis(dataset, dev, gen)
    out["kmeans"] = kmeans_times
    log(f"training variants: phase {time.perf_counter() - phase_t0:.2f} s")
    return out


# --------------------------------------------------------- data parallel --

DP_TIMED_ROUNDS = 4      # grouped / ungrouped step pairs of phase 21 (b)
DP_EHR_STEPS = 2         # EHR steps of phase 21 (c) and (d)
DP_REF_STEPS = 3         # tokenizer steps of the two ranks of phase 21 (d)
DP_REF_CODES = 64        # the global batch of phase 21 (d)
DP_RANKS = 2             # ranks sharing the card over gloo in phase 21 (d)
# the small EHR config of phase 21 (d): no dropout, so card and CPU compute
# one function (tests/test_torch_ehr_train.py's widths)
DP_EHR_CFG = dict(task="readmission", batch_size=8, num_layers=2, hidden_dim=32,
                  input_dim=32, output_dim=32, num_heads=2, max_visits=10,
                  max_medical_code=64, dropout=0.0, pe_dropout=0.0, lr=3e-3,
                  flash_attention=True, flash_precision="highest")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_checkpoint(a: dict, b: dict) -> list[str]:
    """The fields of two checkpoint dicts that are not bitwise equal."""
    import torch

    differ = [k for k in ("step", "pack_rows") if a[k] != b[k]]
    for part in ("model", "buffers"):
        differ += [f"{part} {n}" for n, t in a[part].items() if not torch.equal(t, b[part][n])]
    if a["adam"]["count"] != b["adam"]["count"]:
        differ.append("adam count")
    for key in ("mu", "nu"):
        differ += [f"adam {key} {i}" for i, (x, y) in enumerate(zip(a["adam"][key],
                                                                  b["adam"][key]))
                   if not torch.equal(x, y)]
    if (a["ema"] is None) != (b["ema"] is None):
        differ.append("ema")
    if not torch.equal(a["generator"], b["generator"]):
        differ.append("generator")
    return differ


def dp_cli_world1(keep: Path, argv: list) -> dict:
    """Phase 21 (a): cli.train under the launcher at world size 1 over NCCL,
    phase 16's files and flags to step 2; its checkpoint against phase 16's
    of the same step, bit for bit."""
    import os

    import torch

    results = keep / "results_dp"
    i = argv.index("--results-dir")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "medtok_tpu_torch.cli.train",
           *argv[:i + 1], str(results), *argv[i + 2:], "--max-steps", "2"]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"data parallel (a): torchrun cli.train exited "
          f"{run.returncode}:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    workdir, = results.iterdir()
    log_txt = (workdir / "log.txt").read_text()
    line = next((ln for ln in log_txt.splitlines() if "data parallel:" in ln), "")
    check("1 ranks over nccl" in line, f"data parallel (a): no NCCL group in the log: {line!r}")
    ours = torch.load(workdir / "checkpoints" / "0000002.pt", weights_only=True)
    theirs = torch.load(keep / "phase16_step2.pt", weights_only=True)
    differ = same_checkpoint(ours, theirs)
    check(not differ, f"data parallel (a): the world-1 NCCL checkpoint differs from phase "
          f"16's in {len(differ)} fields: {differ[:8]}")
    n = len(ours["model"]) + len(ours["buffers"]) + 2 * len(ours["adam"]["mu"])
    log(f"data parallel (a): torchrun --nproc-per-node 1 cli.train to step 2 in {wall:.3f} s "
        f"wall; {line.split('] ', 1)[-1]}; its 0000002.pt bitwise equal to phase 16's "
        f"({n} tensors: parameters, usage FIFO buffers, Adam moments; step, count, "
        f"generator, row budget)")
    return dict(wall_s=wall, log=line)


def dp_step_timing(dataset, dev, gen, dp) -> dict:
    """Phase 21 (b): phase 15's step (ModelConfig(), bf16, packed, batch
    1024) with the world-1 NCCL group and without it, on one model and the
    same batches, alternated. Without it means no collective at all: the
    step has no all-reduce and the quantizer's ``dp`` is None for the call
    (no FIFO all-gather), which the phase checks by counting. Logs the
    all-reduced and all-gathered bytes and the all-reduce's own time; K1
    and K2 counted and held to their plain versions on the grouped step's
    inputs."""
    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.config import MedTokConfig, ModelConfig, TrainConfig
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.train.trainer import Trainer, make_train_step, trainable_parameters

    cfg = MedTokConfig(model=ModelConfig(), data=dataset.cfg,
                       train=TrainConfig(packed_text=True, global_batch_size=TRAIN_BATCH))
    batches, _ = train_batches(dataset, cfg, 9)     # the step cycles over 8
    trainer = Trainer(cfg, device=dev, dp=dp)
    grouped = trainer.step_fn
    step_alone = make_train_step(cfg, trainer.model)
    quantize = trainer.model.quantize

    def alone(state, *batch):
        quantize.dp = None
        try:
            return step_alone(state, *batch)
        finally:
            quantize.dp = dp
    state = trainer.init_state()
    ready = [(b.to(dev), trainer.pack(b).to(dev)) for b in batches]
    k1_inputs = []
    distance_topk = vq.distance_topk

    def recorded(z_n, e_n, k, **kw):
        k1_inputs.append((z_n.detach(), e_n.detach(), k))
        return distance_topk(z_n, e_n, k, **kw)

    vq.distance_topk = recorded
    try:
        state, _ = grouped(state, *ready[0])               # warm-up, K1's inputs
    finally:
        vq.distance_topk = distance_topk
    state, _ = alone(state, *ready[0])
    times = {"grouped": [], "alone": []}
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    counted = {}
    with collective_bytes() as moved:
        state, _ = grouped(state, *ready[1])
    counted = {"topk_l2": fused_topk_l2.launches,
               "segment_attention": packed_segment_attention.launches}
    with collective_bytes() as moved_alone:
        state, _ = alone(state, *ready[2])
    check(moved_alone == {"all_reduce": [], "all_gather": []},
          f"data parallel (b): the step without the group moved {moved_alone}")
    check(bool(moved["all_reduce"]) and bool(moved["all_gather"]),
          f"data parallel (b): the grouped step moved {moved}")
    for i in range(DP_TIMED_ROUNDS):
        # alternate which side goes first
        order = (("grouped", grouped), ("alone", alone))
        for label, fn in order if i % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fn(state, *ready[1 + (2 * i + (label == "alone")) % (len(ready) - 1)])
            torch.cuda.synchronize()
            times[label].append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(metrics["loss"])), "data parallel (b): non-finite loss")
    want = {"topk_l2": TRAIN_SWEEPS, "segment_attention": cfg.model.text.num_layers}
    check(counted == want, f"data parallel (b): launches of one grouped step {counted} != "
          f"{want}")
    params = [p for _, p in trainable_parameters(trainer.model)]
    grads = [torch.randn_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    ar_ms = cuda_ms(lambda: dp.all_reduce_mean_(grads), 10)
    nccl_ms = cuda_ms(lambda: dist.all_reduce(flat), 10)
    copy_ms = cuda_ms(lambda: torch.cat([g.reshape(-1) for g in grads]), 10)
    ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"data parallel (b): phase 15's step (ModelConfig(), bf16, packed, batch "
        f"{TRAIN_BATCH}) with the world-1 NCCL group {ms['grouped']:.3f} ms and without "
        f"it {ms['alone']:.3f} ms (median of {DP_TIMED_ROUNDS} alternated steps each: "
        f"grouped {[round(t, 3) for t in times['grouped']]}, alone "
        f"{[round(t, 3) for t in times['alone']]}); difference "
        f"{ms['grouped'] - ms['alone']:+.3f} ms (without the group: no all-reduce and no "
        f"FIFO all-gather, counted {moved_alone})")
    log(f"data parallel (b): one grouped step all-reduced {moved['all_reduce']} (bytes "
        f"of each flat buffer: the {len(params)} trainable gradients, the metrics) and "
        f"all-gathered {moved['all_gather']} (the usage FIFO's indices); "
        f"DataParallel.all_reduce_mean_ of the gradients {ar_ms:.3f} ms of device time, "
        f"of which the NCCL all-reduce of the flat buffer alone {nccl_ms:.3f} ms and "
        f"building the buffer {copy_ms:.3f} ms; launches a grouped step {counted}")
    check(len(k1_inputs) == TRAIN_SWEEPS, f"data parallel (b): {len(k1_inputs)} K1 sweeps")
    for i, (z, e, k) in enumerate(k1_inputs):
        check_k1_case(z, e, f"data-parallel sweep {i}", k=k)
    seg = trainer.pack(batches[0]).to(dev).seg_ids
    check_segment_case(gen, dev, seg, False, "data-parallel packing",
                       H=cfg.model.text.num_heads,
                       Dh=cfg.model.text.hidden_size // cfg.model.text.num_heads)
    del trainer, state, ready
    torch.cuda.empty_cache()
    return dict(ms=ms, launches=counted, moved=moved, allreduce_ms=ar_ms)


@contextlib.contextmanager
def collective_bytes():
    """Within the block, the bytes of each flat all-reduce, each one-tensor
    all-reduce and each all-gather's result that ``DataParallel`` sends,
    listed by kind (collectives of an axis of one rank send nothing)."""
    from medtok_tpu_torch.parallel.mesh import DataParallel

    reduce_flat, reduce_one = DataParallel._all_reduce_flat_, DataParallel.all_reduce_
    gather = DataParallel.all_gather
    moved: dict = {"all_reduce": [], "all_gather": []}

    def counted_reduce(dp, tensors, divide, axis="dp"):
        n = reduce_flat(dp, tensors, divide, axis)
        if not dp.alone(axis):
            moved["all_reduce"].append(n)
        return n

    def counted_reduce_one(dp, tensor, axis, op="sum"):
        out = reduce_one(dp, tensor, axis, op)
        if not dp.alone(axis):
            moved["all_reduce"].append(out.numel() * out.element_size())
        return out

    def counted_gather(dp, tensor, axis="dp"):
        out = gather(dp, tensor, axis)
        if not dp.alone(axis):
            moved["all_gather"].append(out.numel() * out.element_size())
        return out

    DataParallel._all_reduce_flat_, DataParallel.all_reduce_ = counted_reduce, counted_reduce_one
    DataParallel.all_gather = counted_gather
    try:
        yield moved
    finally:
        DataParallel._all_reduce_flat_, DataParallel.all_reduce_ = reduce_flat, reduce_one
        DataParallel.all_gather = gather


def dp_ehr_world1(table, ehr: dict, dev, dp) -> dict:
    """Phase 21 (c): EHRTrainer at EHRTrainConfig() width with the world-1
    NCCL group and without it, from one seed, DP_EHR_STEPS steps on the same
    batches: losses and parameters bitwise equal, 4 launches of each K3
    kernel a grouped step."""
    import torch

    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer

    cfg = EHRTrainConfig()
    batches = (ehr["eval"] + ehr["val"])[:DP_EHR_STEPS]
    runs = {}
    for label, group in (("grouped", dp), ("alone", None)):
        trainer = EHRTrainer(cfg, table, 2, device=dev, dp=group)
        for f in k3_wrappers():
            f.launches = 0
        losses = [trainer.train_step(b)[0] for b in batches]
        torch.cuda.synchronize()
        runs[label] = dict(losses=torch.stack(losses).cpu(), counts=k3_counts(),
                           params={n: p.detach().clone()
                                   for n, p in trainer.model.state_dict().items()})
        del trainer
    g, a = runs["grouped"], runs["alone"]
    check(torch.equal(g["losses"], a["losses"]),
          f"data parallel (c): losses {g['losses'].tolist()} != {a['losses'].tolist()}")
    differ = [n for n, t in g["params"].items() if not torch.equal(t, a["params"][n])]
    check(not differ, f"data parallel (c): parameters differ: {differ[:8]}")
    want = {k: cfg.num_layers * DP_EHR_STEPS for k in ("fwd", "dq", "dkv")}
    check(g["counts"] == want, f"data parallel (c): K3 launches {g['counts']} != {want}")
    log(f"data parallel (c): EHRTrainer at EHRTrainConfig() width, {DP_EHR_STEPS} steps "
        f"with the world-1 NCCL group and without it: losses "
        f"{[round(float(x), 6) for x in g['losses']]} and all {len(g['params'])} tensors of "
        f"the state_dict bitwise equal; K3 launches {g['counts']} ({cfg.num_layers} of "
        f"each a step)")
    return dict(counts=g["counts"])


def k3_wrappers():
    from medtok_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv


def dp_spec(dataset, seed: int) -> dict:
    """The inputs of phase 21 (d): DP_REF_STEPS global tokenizer batches of
    phase 5's codes, and small EHR data (DP_EHR_CFG's shapes) with its
    table."""
    import numpy as np

    from medtok_tpu_torch.ehr.train import prepare_task_features

    batches = [dataset.make_batch(list(range(i * DP_REF_CODES, (i + 1) * DP_REF_CODES)),
                                  aug_seed=i + 1) for i in range(DP_REF_STEPS)]
    rng = np.random.default_rng(seed + 21)
    vocab = 512
    c = DP_EHR_CFG
    n = c["batch_size"] * (DP_EHR_STEPS + 1)
    data = ehr_samples(rng, n, vocab, c["max_medical_code"])
    labels = np.asarray([d[0]["label"] for d in data])
    feats, fz = prepare_task_features(data, labels, 2, "readmission", vocab_size=vocab,
                                      max_visits=c["max_visits"],
                                      max_medical_code=c["max_medical_code"])
    bs = c["batch_size"]
    ehr = [tuple(fz.collate(feats[i * bs:(i + 1) * bs])) for i in range(DP_EHR_STEPS)]
    table = rng.normal(size=(vocab, 256)).astype(np.float32)
    return dict(batches=[tuple(b) for b in batches], ehr=ehr, table=table)


def dp_local(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a global batch (NamedTuple of
    numpy arrays; the flat edge fields by graph)."""
    B = batch[0].shape[0]
    lb = B // world
    return type(batch)(*(a[rank * lb * (a.shape[0] // B if n.startswith("edge") else 1):
                           (rank + 1) * lb * (a.shape[0] // B if n.startswith("edge") else 1)]
                         for n, a in zip(batch._fields, batch)))


def dp_rank(rank: int, world: int, root: Path) -> int:
    """One rank of phase 21 (d), started by ``dp_two_ranks``: a gloo group
    on the card shared with the other rank. Tokenizer: the k-means init of
    the global first batch, then (from random unit rows, a few dead) three
    packed fp32 steps of a GCN + kmeans + revival model at the verify
    recipe's widths, each replayed on the CPU from the card's state (the
    same group, CPU tensors); EHR: DP_EHR_STEPS steps, each replayed the
    same way. Writes rank{rank}.pkl under root."""
    import pickle

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.config import DataConfig, MedTokConfig, TrainConfig
    from medtok_tpu_torch.data.types import CodeBatch
    from medtok_tpu_torch.ehr.dataset import EHRBatch
    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer
    from medtok_tpu_torch.models.tokenizer_model import PATH_ORDER
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.parallel import mesh
    from medtok_tpu_torch.train import trainer as tr
    from medtok_tpu_torch.utils.checkpoint import load_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{root / 'group'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    card_dp = mesh.initialize_distributed(dev)
    cpu_dp = mesh.DataParallel(rank, world, torch.device("cpu"))
    spec = pickle.loads((root / "spec.pkl").read_bytes())
    out: dict = {"tokenizer": [], "ehr": []}

    model_cfg = variant_model_config()
    model_cfg = dataclasses.replace(model_cfg, graph=dataclasses.replace(
        model_cfg.graph, model_name="GCN"))
    cfg = MedTokConfig(model=model_cfg, data=DataConfig(),
                       train=TrainConfig(packed_text=True, global_batch_size=DP_REF_CODES,
                                         lr=1e-3, max_grad_norm=0.5))
    grads: list = []
    adam_step = tr.ClippedAdam.step

    def spy(self, params, gs, st):
        grads.append([g.detach().float().cpu().clone() for g in gs])
        return adam_step(self, params, gs, st)

    tr.ClippedAdam.step = spy

    def tokens_of(model):
        seen = []
        forward_train = model.forward_train

        def spy_forward(*a, **kw):
            o = forward_train(*a, **kw)
            seen.append((torch.stack([o[f"{p}_tokens"] for p in PATH_ORDER], 1).cpu().numpy(),
                         torch.stack([o[f"{p}_tokens_weights"] for p in PATH_ORDER], 1)
                         .detach().cpu().numpy()))
            return o

        model.forward_train = spy_forward
        return seen

    logged = {"card": [], "cpu": []}
    card = tr.Trainer(cfg, device=dev, dp=card_dp,
                      log_fn=lambda s, m: logged["card"].append(m))
    cpu = tr.Trainer(cfg, device="cpu", dp=cpu_dp, log_fn=lambda s, m: logged["cpu"].append(m))
    card_state, cpu_state = card.init_state(), cpu.init_state()
    local = [dp_local(CodeBatch(*b), rank, world) for b in spec["batches"]]
    tr.kmeans_init_codebook(card.model, card_state, [local[0]], dp=card_dp)
    q = card.model.quantize
    out["kmeans"] = (q.ema_codebook.cpu().clone(), q.ema_cluster.cpu().clone())
    C = q.cfg.codebook_size
    x = torch.randn(q.ema_codebook.shape, generator=torch.Generator().manual_seed(7))
    q.ema_codebook = (x / x.norm(dim=-1, keepdim=True)).to(dev)
    q.ema_embed_prob = torch.full((C,), 1.0 / C).index_fill_(
        0, torch.tensor(VARIANT_REVIVED), 0.0).to(dev)
    card_tokens, cpu_tokens = tokens_of(card.model), tokens_of(cpu.model)
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    for b in local:
        sd = {k: v.cpu() for k, v in card.model.state_dict().items()}
        load_weights(cpu.model, {"model": sd, "buffers": {
            n: t.cpu() for n, t in card.model.named_buffers() if n not in sd}})
        cpu_state.opt_state.count = card_state.opt_state.count
        with torch.no_grad():
            for dst, src in ((cpu_state.opt_state.mu, card_state.opt_state.mu),
                             (cpu_state.opt_state.nu, card_state.opt_state.nu)):
                for d, t in zip(dst, src):
                    d.copy_(t.cpu())
        card_state = card.fit(card_state, [b])
        card_grads = grads[-1]
        cpu.pack_rows = card.pack_rows
        cpu_state = cpu.fit(cpu_state, [b])
        names = [n for n, _ in tr.trainable_parameters(card.model)]
        out["tokenizer"].append(dict(
            metrics=(logged["card"][-1], logged["cpu"][-1]),
            grads=(dict(zip(names, card_grads)), dict(zip(names, grads[-1]))),
            tokens=(card_tokens[-1], cpu_tokens[-1]),
            state={**{f"param {n}": t.detach().cpu().clone()
                      for n, t in card.model.state_dict().items()},
                   **{f"buffer {n}": t.cpu().clone() for n, t in card.model.named_buffers()},
                   **{f"mu {i}": t.cpu().clone()
                      for i, t in enumerate(card_state.opt_state.mu)}}))
    out["tokenizer_launches"] = {"topk_l2": fused_topk_l2.launches,
                                 "segment_attention": packed_segment_attention.launches}
    out["pack_rows"] = card.pack_rows

    ecfg = EHRTrainConfig(**DP_EHR_CFG)
    ecard = EHRTrainer(ecfg, spec["table"], 2, device=dev, dp=card_dp)
    ecpu = EHRTrainer(ecfg, spec["table"], 2, device="cpu", dp=cpu_dp)
    for f in k3_wrappers():
        f.launches = 0
    for b in spec["ehr"]:
        block = dp_local(EHRBatch(*b), rank, world)
        ecpu.model.load_state_dict({k: v.cpu() for k, v in ecard.model.state_dict().items()})
        ecpu.optimizer.load_state_dict(ecard.optimizer.state_dict())
        ecpu.step = ecard.step
        loss_card, _ = ecard.train_step(block)
        loss_cpu, _ = ecpu.train_step(block)
        out["ehr"].append(dict(
            loss=(float(loss_card), float(loss_cpu)),
            grads=({n: p.grad.cpu().clone() for n, p in ecard.model.named_parameters()},
                   {n: p.grad.clone() for n, p in ecpu.model.named_parameters()}),
            state={n: t.detach().cpu().clone() for n, t in ecard.model.state_dict().items()}))
    out["ehr_launches"] = k3_counts()
    out["staged"] = sorted(mesh.STAGED_OPS)
    out["backend"] = card_dp.backend
    (root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    card_dp.barrier()
    dist.destroy_process_group()
    return 0


def dp_two_ranks(dataset, seed: int, root: Path) -> dict:
    """Phase 21 (d): DP_RANKS ranks share the card over gloo (NCCL takes one
    rank a device). Their parameters, buffers and Adam moments bitwise
    equal after every step, and the k-means init's codebook; each step held
    to its CPU replay from the same state: loss terms within 1e-5 relative
    (2e-6 absolute for the InfoNCE terms), gradients within 1e-4 of each
    tensor's largest (the key bias, exact gradient 0, against the key
    weight's), token rows by phase 5's tie-gap rule."""
    import os
    import pickle

    import torch

    root.mkdir(parents=True, exist_ok=True)
    (root / "spec.pkl").write_bytes(pickle.dumps(dp_spec(dataset, seed)))
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), "--dp-world", str(DP_RANKS), "--dp-root", str(root)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(DP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"data parallel (d): rank {r} exited {p.returncode}:\n"
              f"{text[-4000:]}")
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(DP_RANKS)]
    a = ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        check(all(torch.equal(x, y) for x, y in zip(a["kmeans"], other["kmeans"])),
              f"data parallel (d): rank {r}'s k-means codebook differs from rank 0's")
        for part in ("tokenizer", "ehr"):
            for k, (s0, s1) in enumerate(zip(a[part], other[part])):
                differ = [n for n, t in s0["state"].items() if not torch.equal(t, s1["state"][n])]
                check(not differ, f"data parallel (d): rank {r}'s {part} state after step "
                      f"{k + 1} differs from rank 0's in {differ[:8]}")
    loss_err = grad_err = ehr_loss_err = ehr_grad_err = max_gap = 0.0
    for rank in ranks:
        for step in rank["tokenizer"]:
            got, want = step["metrics"]
            for name, w in want.items():
                if name == "steps_per_sec":
                    continue
                x = got[name]
                check(abs(x - w) <= max(1e-5 * abs(w), 2e-6),
                      f"data parallel (d): {name} {x} on the card, {w} on the CPU")
                loss_err = max(loss_err, abs(x - w) / max(abs(w), 1e-6))
            grad_err = max(grad_err, dp_grad_err(*step["grads"]))
            gaps = tie_gaps(step["tokens"][0][0], step["tokens"][0][1],
                            step["tokens"][1][0], step["tokens"][1][1])
            max_gap = max(max_gap, float(gaps.max(initial=0.0)))
        for step in rank["ehr"]:
            x, w = step["loss"]
            check(abs(x - w) <= 1e-5 * abs(w), f"data parallel (d): EHR loss {x} vs {w}")
            ehr_loss_err = max(ehr_loss_err, abs(x - w) / abs(w))
            ehr_grad_err = max(ehr_grad_err, dp_grad_err(*step["grads"]))
    check(grad_err <= 1e-4, f"data parallel (d): tokenizer gradients off by {grad_err:.3e}")
    check(ehr_grad_err <= 1e-4, f"data parallel (d): EHR gradients off by {ehr_grad_err:.3e}")
    check(max_gap <= 1e-5, f"data parallel (d): token rows differ beyond a tie ({max_gap})")
    want = {"topk_l2": TRAIN_SWEEPS * DP_REF_STEPS, "segment_attention": 2 * DP_REF_STEPS}
    for r, rank in enumerate(ranks):
        check(rank["tokenizer_launches"] == want, f"data parallel (d): rank {r}'s launches "
              f"{rank['tokenizer_launches']} != {want}")
        ehr_want = {k: DP_EHR_CFG["num_layers"] * DP_EHR_STEPS for k in ("fwd", "dq", "dkv")}
        check(rank["ehr_launches"] == ehr_want, f"data parallel (d): rank {r}'s K3 launches "
              f"{rank['ehr_launches']} != {ehr_want}")
    n_state = len(a["tokenizer"][0]["state"])
    log(f"data parallel (d): {DP_RANKS} ranks on the card over {a['backend']} ({wall:.3f} s "
        f"wall): the k-means init's codebook and, after each of {DP_REF_STEPS} tokenizer "
        f"steps (GCN + kmeans + revival, verify-recipe widths, fp32, packed, {DP_REF_CODES} "
        f"codes a global batch, row budget {a['pack_rows']}) and {DP_EHR_STEPS} EHR steps, all "
        f"{n_state} tokenizer tensors (parameters, buffers, Adam first moments) and the EHR "
        f"state_dict bitwise equal across the ranks; against the CPU replay of each step: "
        f"loss terms within {loss_err:.3e}, gradients within {grad_err:.3e} of the largest, "
        f"token rows max tie gap {max_gap:.3e}; EHR loss within {ehr_loss_err:.3e}, gradients "
        f"within {ehr_grad_err:.3e}; launches a rank: {a['tokenizer_launches']} and K3 "
        f"{a['ehr_launches']}; collectives staged through the host on gloo: "
        f"{a['staged'] or 'none'}")
    return dict(wall_s=wall, launches=a["tokenizer_launches"], k3=a["ehr_launches"],
                staged=a["staged"])


def dp_grad_err(got: dict, want: dict) -> float:
    """The largest gradient error, relative to each tensor's largest CPU
    gradient; the key bias (exact gradient 0) held within 1e-5 of the key
    weight's largest."""
    import numpy as np

    err = 0.0
    for name, w in want.items():
        g, w = got[name].float().numpy(), w.float().numpy()
        if name.endswith("k_proj.bias"):
            scale = np.abs(want[name.replace("bias", "weight")].numpy()).max()
            check(max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * scale,
                  f"data parallel (d): {name} is not noise around 0")
            continue
        if not w.any():
            check(not g.any(), f"data parallel (d): {name} is 0 on the CPU only")
            continue
        err = max(err, float(np.abs(g - w).max() / np.abs(w).max()))
    return err


def run_data_parallel(dataset, table, ehr: dict, dev, gen, keep: Path, argv: list,
                      seed: int) -> dict:
    """Phase 21: data parallel. (a) cli.train under torchrun at world size
    1 over NCCL, its checkpoint bitwise phase 16's; (b) and (c) inside one
    world-1 NCCL group joined here (the launcher's environment set by hand):
    the tokenizer step with and without the group, the EHR steps with and
    without it; (d) two ranks sharing the card over gloo, against the CPU."""
    import gc
    import os

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.parallel.mesh import initialize_distributed, warmup_collectives

    phase_t0 = time.perf_counter()
    # the torchrun and rank processes share the card with this one: hand
    # back what the caching allocator keeps from the earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    log(f"data parallel: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    out = {"cli": dp_cli_world1(keep, argv)}
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        dp = initialize_distributed(dev)
        init_s = time.perf_counter() - t0
        warmup_collectives(dp)
        log(f"data parallel: world-1 NCCL group joined in {init_s:.3f} s, warmed up in "
            f"{time.perf_counter() - t0 - init_s:.3f} s (backend {dp.backend})")
        check(dp.backend == "nccl", f"data parallel: backend {dp.backend}, want nccl")
        out["step"] = dp_step_timing(dataset, dev, gen, dp)
        out["ehr"] = dp_ehr_world1(table, ehr, dev, dp)
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for key in env:
            os.environ.pop(key, None)
    out["ranks"] = dp_two_ranks(dataset, seed, keep / "ranks")
    log(f"data parallel: phase {time.perf_counter() - phase_t0:.2f} s")
    return out


# ----------------------------------------------------- tensor parallel --

TP_RANKS = 2            # tp ranks sharing the card over gloo in phase 22
TP_STEPS = 3            # tokenizer steps of phase 22 (a)
TP_QA_LAYERS = 2        # phase 22 (b): LLAMA31_8B's widths, depth cut to 2 layers
TP_QA_BATCH = 4         # and B to 4, so gloo's host-staged all-reduces stay short
TP_QA_STEPS = 2
TP_QA_NEW_TOKENS = 16


def tp_digests(trainer, state) -> dict:
    """A SHA-1 of every trained tensor's bytes: the trainable parameters,
    the quantizer's buffers (usage FIFO) and Adam's first moments (the
    frozen BERT never changes)."""
    import hashlib

    import torch

    named = [(n, t) for n, t in trainer.model.state_dict().items()
             if not n.startswith("text_model.")]
    named += [(f"buffer {n}", t) for n, t in trainer.model.named_buffers()]
    named += [(f"mu {i}", t) for i, t in enumerate(state.opt_state.mu)]
    return {n: hashlib.sha1(t.detach().contiguous().flatten().view(torch.uint8).cpu()
                            .numpy().tobytes()).hexdigest() for n, t in named}


def tp_train_run(cfg_dict: dict, batches: list, dev, mesh) -> dict:
    """Phase 22 (a)'s run: TP_STEPS steps of Trainer.fit at ModelConfig()
    width on ``mesh`` (None: one device) from the seed's weights, over the
    global batches (every tp rank takes the whole batch: dp 1). Per step
    the metrics, the four paths' tokens and weights, tp_digests and the
    step's ms; K1's launches over the steps, and each K1 call of the first
    step held to the plain version afterwards."""
    import torch

    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.data.types import CodeBatch
    from medtok_tpu_torch.models.tokenizer_model import PATH_ORDER
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.train.trainer import Trainer

    cfg = MedTokConfig.from_dict(cfg_dict)
    tp = 1 if mesh is None else mesh.tp_size
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_tp=tp))
    logged = []
    trainer = Trainer(cfg, device=dev, dp=mesh, log_fn=lambda step, m: logged.append(m))
    state = trainer.init_state()
    seen = []
    forward_train = trainer.model.forward_train

    def spy_forward(*a, **kw):
        o = forward_train(*a, **kw)
        seen.append((torch.stack([o[f"{p}_tokens"] for p in PATH_ORDER], 1).cpu().numpy(),
                     torch.stack([o[f"{p}_tokens_weights"] for p in PATH_ORDER], 1)
                     .detach().float().cpu().numpy()))
        return o

    trainer.model.forward_train = spy_forward
    # the first step's K1 inputs: the block of each sweep a rank launches on
    calls, one_dev, tp_sweep = [], vq.distance_topk, vq.distance_topk_tp

    def rec_one(z_n, e_n, k, **kw):
        if not seen:
            calls.append((z_n.detach().clone(), e_n.detach().clone(), k))
        return one_dev(z_n, e_n, k, **kw)

    def rec_tp(z_n, e_n, k, mesh, *, region=None):
        n = e_n.shape[0]
        lo, hi = (0, n) if region is None else region
        block = n // mesh.tp_size
        a, b = max(lo, mesh.tp_index * block), min(hi, (mesh.tp_index + 1) * block)
        if not seen and b > a:
            calls.append((z_n.detach().clone(), e_n.detach()[a:b].clone(), min(k, b - a)))
        return tp_sweep(z_n, e_n, k, mesh, region=region)

    vq.distance_topk, vq.distance_topk_tp = rec_one, rec_tp
    kernel = fused_topk_l2
    kernel.launches = 0
    steps = []
    try:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, [CodeBatch(*b)])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            steps.append(dict(metrics={k: v for k, v in logged[-1].items()
                                       if k != "steps_per_sec"},
                              tokens=seen[-1][0], weights=seen[-1][1],
                              digests=tp_digests(trainer, state), ms=ms))
    finally:
        vq.distance_topk, vq.distance_topk_tp = one_dev, tp_sweep
    launches = kernel.launches
    where = "one device" if mesh is None else f"tp rank {mesh.tp_index} of {tp}"
    errs = [check_k1_case(z, e, f"phase 22 (a) {where}, sweep {i}", k=k)
            for i, (z, e, k) in enumerate(calls)]
    shapes = [(tuple(z.shape), tuple(e.shape)) for z, e, _ in calls]
    del trainer, state
    torch.cuda.empty_cache()
    return dict(steps=steps, launches=launches, k1_err=max(errs, default=0.0), k1_shapes=shapes)


def tp_qa_run(spec: dict, dev, mesh) -> dict:
    """Phase 22 (b)'s run: QAFinetuner at LLAMA31_8B's widths cut to
    TP_QA_LAYERS layers, bf16, LoRA r = 16 (its lora_b drawn nonzero from a
    CPU generator, each rank keeping its slice), remat, B = TP_QA_BATCH,
    total_len 512, on ``mesh`` (None: one device). Greedy generate of
    TP_QA_NEW_TOKENS tokens on TP_QA_BATCH prompts from the initial
    weights, then TP_QA_STEPS train steps (loss, ms, the bytes each step's
    collectives moved), the lora_b tensors gathered to the one-device
    layout, and greedy generate again from the trained weights. Each
    generate comes with the prompts' last-position logits and, on one
    device, the top-2 logit gap of each chosen token."""
    import torch

    from medtok_tpu_torch.qa import sharding
    from medtok_tpu_torch.qa.finetune import QAFinetuneConfig, QAFinetuner, _collate_rows
    from medtok_tpu_torch.qa.llama import LLAMA31_8B, LlamaModel, generate

    llm = dataclasses.replace(LLAMA31_8B, num_layers=TP_QA_LAYERS, remat=True)
    tp = 1 if mesh is None else mesh.tp_size
    qcfg = QAFinetuneConfig(lora_rank=QA_LORA_RANK, cutoff_len=QA_CUTOFF, total_len=QA_TOTAL,
                            batch_size=TP_QA_BATCH, seed=spec["seed"], mesh_tp=tp)
    ft = QAFinetuner(llm, spec["table"], qcfg, device=dev, dtype=torch.bfloat16, dp=mesh)
    ft.init_params()
    full = dict(LlamaModel(ft.llm_cfg, device="meta").named_parameters())
    g = torch.Generator().manual_seed(spec["seed"] + 1)
    with torch.no_grad():   # nonzero lora_b, so the adapters act on the outputs
        for name, p in ft.model.named_parameters():
            if name.endswith("lora_b"):
                t = torch.empty(full[name].shape).normal_(0.0, 0.02, generator=g)
                p.copy_(t if mesh is None else sharding.local_slice(
                    name, t, ft.llm_cfg, tp, mesh.tp_index))
    pb = _collate_rows(spec["prompts"][:TP_QA_BATCH], cutoff_len=QA_CUTOFF)

    def greedy() -> dict:
        with torch.no_grad():
            packed = ft.soft_prompt(
                torch.as_tensor(pb["input_ids"], dtype=torch.long, device=dev),
                torch.as_tensor(pb["attention_mask"], dtype=torch.long, device=dev),
                None, ft.model.embed, qcfg.total_len)
            hidden, _ = ft.model(inputs_embeds=packed.inputs_embeds,
                                 attention_mask=packed.attention_mask, return_hidden=True)
            logits = ft.model.full_logits(hidden[:, -1]).float().cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(ft.model, packed.inputs_embeds, packed.attention_mask,
                        max_new_tokens=TP_QA_NEW_TOKENS, temperature=0.0, device=dev)
        return dict(tokens=toks, logits=logits, s=time.perf_counter() - t0,
                    gaps=qa_top2_gap(qa_step_logits(ft, packed, toks)) if mesh is None
                    else None)

    ft.model.eval()
    before = greedy()
    ft.model.train()
    rows = spec["rows"]
    losses, times, moved = [], [], []
    for s in range(TP_QA_STEPS):
        batch = _collate_rows(rows[s * TP_QA_BATCH:(s + 1) * TP_QA_BATCH],
                              cutoff_len=QA_CUTOFF)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes() as m:
            loss = ft.train_step(batch)
            losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
        moved.append({k: sum(v) for k, v in m.items()} | {"calls": sum(map(len, m.values()))})
    lora_b = {n: sharding.gather_param(n, p.detach(), ft.model.mesh, ft.llm_cfg).float().cpu()
              for n, p in ft.model.named_parameters() if n.endswith("lora_b")}
    ft.model.eval()
    after = greedy()
    del ft
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=times, moved=moved, lora_b=lora_b, before=before,
                after=after)


def tp_rank(rank: int, world: int, root: Path) -> int:
    """One rank of phase 22, started by ``run_tensor_parallel``: a gloo
    group on the card shared with the other rank, the (dp 1, tp world)
    mesh over it; phase 22 (a), then (b). Writes rank{rank}.pkl under
    root."""
    import pickle

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{root / 'group'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = mesh_mod.initialize_distributed(dev, dp=1, tp=world)
    spec = pickle.loads((root / "spec.pkl").read_bytes())
    t0 = time.perf_counter()
    out = {"tokenizer": tp_train_run(spec["cfg"], spec["batches"], dev, mesh)}
    out["tokenizer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["qa"] = tp_qa_run(spec, dev, mesh)
    out["qa_s"] = time.perf_counter() - t0
    out["tp_index"], out["backend"] = mesh.tp_index, mesh.backend
    out["staged"] = sorted(mesh_mod.STAGED_OPS)
    (root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    mesh.barrier()
    dist.destroy_process_group()
    return 0


def tp_hold(one: dict, ranks: list) -> None:
    """Phase 22's checks of the ranks' results (``tp_rank``) against the
    one-device runs (``tp_train_run`` and ``tp_qa_run`` without a mesh), in
    the order of ``run_tensor_parallel``'s docstring; logs what it held."""
    import numpy as np

    check(sorted(r["tp_index"] for r in ranks) == list(range(TP_RANKS)),
          "tensor parallel: the ranks' tp indices")

    # (a) the tokenizer
    ref = one["tokenizer"]
    check(ref["launches"] == TP_STEPS * TRAIN_SWEEPS, f"tensor parallel (a): the one-device "
          f"run launched K1 {ref['launches']} times, want {TP_STEPS * TRAIN_SWEEPS}")
    want_launches = TP_STEPS * (2 + 2)      # shared text and graph, the rank's region twice
    for r, rank in enumerate(ranks):
        a = rank["tokenizer"]
        check(a["launches"] == want_launches, f"tensor parallel (a): rank {r} launched K1 "
              f"{a['launches']} times, want {want_launches}")
        for k, (x, y) in enumerate(zip(a["steps"], ranks[0]["tokenizer"]["steps"])):
            differ = [n for n, d in x["digests"].items() if d != y["digests"][n]]
            check(not differ and x["metrics"] == y["metrics"]
                  and np.array_equal(x["tokens"], y["tokens"]),
                  f"tensor parallel (a): rank {r} differs from rank 0 after step {k + 1} in "
                  f"{differ[:8]}")
    notes, tied = [], False
    for k, (x, y) in enumerate(zip(ranks[0]["tokenizer"]["steps"], ref["steps"])):
        rows = int((x["tokens"] != y["tokens"]).any(axis=-1).sum())
        gaps = tie_gaps(x["tokens"], x["weights"], y["tokens"], y["weights"])
        max_gap = float(gaps.max(initial=0.0))
        check(max_gap <= 1e-5, f"tensor parallel (a): step {k + 1}: token rows differ "
              f"beyond a tie (gap {max_gap})")
        tied = tied or rows > 0
        differ = [n for n, d in x["digests"].items() if d != y["digests"][n]]
        losses_equal = x["metrics"] == y["metrics"]
        check(tied or (not differ and losses_equal),
              f"tensor parallel (a): step {k + 1}: no token row differs, yet the metrics "
              f"(equal: {losses_equal}) or tensors {differ[:8]} do")
        notes.append(f"step {k + 1}: {rows} of {x['tokens'].shape[0] * 4} token rows differ "
                     f"(max tie gap {max_gap:.3e}), {len(differ)} of {len(x['digests'])} "
                     f"tensors and {'equal' if losses_equal else 'different'} metrics")
    tp_ms = [round(s["ms"], 3) for s in ranks[0]["tokenizer"]["steps"]]
    one_ms = [round(s["ms"], 3) for s in ref["steps"]]
    log(f"tensor parallel (a): phase 15's training (ModelConfig(), bf16, packed, batch "
        f"{TRAIN_BATCH}), {TP_STEPS} steps on the (dp 1, tp {TP_RANKS}) mesh over "
        f"{ranks[0]['backend']} against one device: " + "; ".join(notes)
        + f"; the ranks bitwise equal after every step; K1 launches a rank "
        f"{[r['tokenizer']['launches'] for r in ranks]} (one device {ref['launches']}), "
        f"shapes of rank 0's first step {ranks[0]['tokenizer']['k1_shapes']}, K1 held to its "
        f"plain version (max |value err| "
        f"{max(r['tokenizer']['k1_err'] for r in ranks):.3e}); step ms tp rank 0 {tp_ms}, one "
        f"device {one_ms}; loss {ranks[0]['tokenizer']['steps'][-1]['metrics']['loss']:.6f}")

    # (b) QA
    q1 = one["qa"]
    for r, rank in enumerate(ranks):
        q = rank["qa"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(q["losses"], q1["losses"]))
        check(rel <= 1e-2, f"tensor parallel (b): rank {r} losses {q['losses']}, one device "
              f"{q1['losses']}")
        worst = 0.0
        for n, w in q1["lora_b"].items():
            err = float((q["lora_b"][n] - w).abs().max() / w.abs().max())
            worst = max(worst, err)
            check(err <= 5e-2, f"tensor parallel (b): rank {r}'s gathered {n} off by {err:.3e} "
                  f"of its largest entry")
        q["rel"], q["lora_err"] = rel, worst
    for key in ("before", "after"):
        check(all(np.array_equal(r["qa"][key]["tokens"], ranks[0]["qa"][key]["tokens"])
                  for r in ranks), f"tensor parallel (b): the ranks' greedy tokens differ "
              f"({key} training)")

    def first_differences(key) -> list:
        """(row, step, one-device top-2 gap) where each row first differs."""
        toks, ref = ranks[0]["qa"][key], q1[key]
        out = []
        for row in range(toks["tokens"].shape[0]):
            diff = np.flatnonzero(toks["tokens"][row] != ref["tokens"][row])
            if len(diff):
                out.append((row, int(diff[0]), float(ref["gaps"][row, int(diff[0])])))
        return out

    def logit_err(key) -> float:
        got, want = ranks[0]["qa"][key]["logits"], q1[key]["logits"]
        return float((got - want).abs().max() / want.abs().max())

    q = ranks[0]["qa"]
    first = {key: first_differences(key) for key in ("before", "after")}
    notes = {key: (f"rows first differ at (row, step, one-device gap) {first[key]}"
                   if first[key] else "identical (smallest one-device top-2 gap "
                   f"{float(q1[key]['gaps'].min()):.3e})") for key in first}
    log(f"tensor parallel (b): QA at LLAMA31_8B widths, {TP_QA_LAYERS} layers, bf16, LoRA "
        f"r={QA_LORA_RANK}, remat, B={TP_QA_BATCH}, total_len {QA_TOTAL}, {TP_QA_STEPS} steps "
        f"on the (dp 1, tp {TP_RANKS}) mesh over gloo against one device: losses "
        f"{[round(x, 5) for x in q['losses']]} vs {[round(x, 5) for x in q1['losses']]} "
        f"(rel {max(r['qa']['rel'] for r in ranks):.3e}), gathered lora_b within "
        f"{max(r['qa']['lora_err'] for r in ranks):.3e} of the largest entry; step ms "
        f"{[round(t, 3) for t in q['step_ms']]} vs one device "
        f"{[round(t, 3) for t in q1['step_ms']]}; a step moved {q['moved']} bytes (rank 0; "
        f"the one-device step {q1['moved']}); the prompts' last logits off by "
        f"{logit_err('before'):.3e} of the largest before training, {logit_err('after'):.3e} "
        f"after; greedy {TP_QA_NEW_TOKENS} tokens from the same weights: {notes['before']}; "
        f"from the trained weights: {notes['after']}; generate {q['before']['s']:.3f} s vs "
        f"{q1['before']['s']:.3f} s")
    for row, step, gap in first["before"]:
        check(gap <= 1e-2, f"tensor parallel (b): row {row}'s greedy token {step} differs "
              f"where the one-device top-2 gap is {gap:.3e} of its largest logit")


def run_tensor_parallel(dataset, table, dev, seed: int, root: Path) -> dict:
    """Phase 22: the (dp 1, tp TP_RANKS) mesh, its ranks sharing the card
    over gloo (NCCL refuses two ranks on one device). (a) the tokenizer's
    tensor-parallel codebook sweep in phase 15's training (ModelConfig(),
    bf16, packed, batch 1024) against the one-device step on the same
    batches: tokens, losses and trained tensors bitwise equal, or else each
    differing token row tied within 1e-5; the two ranks bitwise equal after
    every step; K1 launched on each rank whose block meets a sweep's region
    (4 a step each: the shared sweeps, and the rank's one specific region)
    and held to its plain version on each first-step call. (b) QA at
    LLAMA31_8B's widths (2 layers, B 4) against the one-device port:
    losses within 1e-2 relative, the gathered lora_b within 5e-2 of its
    largest entry, greedy tokens equal wherever the one-device top-2 logit
    gap exceeds 1e-2; bytes all-reduced a step and the step's ms beside the
    one-device step's."""
    import gc
    import os
    import pickle

    import torch

    from medtok_tpu_torch.cli.qa import _simple_tokenize
    from medtok_tpu_torch.config import MedTokConfig, ModelConfig, TrainConfig
    from medtok_tpu_torch.qa.inference import extend_with_miss_rows
    from medtok_tpu_torch.qa.llama import LLAMA31_8B

    phase_t0 = time.perf_counter()
    cfg = MedTokConfig(model=ModelConfig(), data=dataset.cfg,
                       train=TrainConfig(packed_text=True, global_batch_size=TRAIN_BATCH))
    batches, _ = train_batches(dataset, cfg, TP_STEPS)

    def tokenize(text):
        return _simple_tokenize(text, LLAMA31_8B.vocab_size)

    spec = dict(cfg=dataclasses.asdict(cfg), batches=[tuple(b) for b in batches], seed=seed,
                table=extend_with_miss_rows(table, QA_MISS_ROWS, seed=seed),
                rows=qa_rows(tokenize, QA_CUTOFF, True)[:TP_QA_BATCH * TP_QA_STEPS],
                prompts=qa_rows(tokenize, QA_CUTOFF, False)[:TP_QA_BATCH])
    t0 = time.perf_counter()
    one = {"tokenizer": tp_train_run(spec["cfg"], spec["batches"], dev, None)}
    t1 = time.perf_counter()
    one["qa"] = tp_qa_run(spec, dev, None)
    t2 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    root.mkdir(parents=True, exist_ok=True)
    (root / "spec.pkl").write_bytes(pickle.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t3 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank",
                               str(r), "--tp-world", str(TP_RANKS), "--tp-root", str(root)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(TP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t3
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"tensor parallel: rank {r} exited {p.returncode}:\n"
              f"{text[-4000:]}")
    for r, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("K1 phase 22"):
                log(f"  rank {r}: {line}")
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(TP_RANKS)]
    tp_hold(one, ranks)
    log(f"tensor parallel: one-device references (a) {t1 - t0:.2f} s, (b) {t2 - t1:.2f} s; "
        f"{TP_RANKS} rank processes {wall:.2f} s wall (tokenizer "
        f"{[round(r['tokenizer_s'], 2) for r in ranks]} s, QA "
        f"{[round(r['qa_s'], 2) for r in ranks]} s); staged through the host on gloo "
        f"{ranks[0]['staged']}; phase "
        f"{time.perf_counter() - phase_t0:.2f} s")
    return dict(launches=[r["tokenizer"]["launches"] for r in ranks], wall_s=wall)


# ------------------------------------------------ data-parallel export --

DPX_RANKS = 2           # ranks sharing the card over gloo in phase 23 (b)


def dpx_printed(printed: str, label: str) -> dict:
    """What rank 0 of a data-parallel ``cli.export`` printed: the export's
    seconds, the world size, the backend, the gather's seconds and bytes,
    and each rank's (K1, K2) launches."""
    g = re.search(r"data parallel: (\d+) ranks over (\w+), the gather ([0-9.]+) s for "
                  r"(\d+) bytes; launches \(K1, K2\) by rank (.*)$", printed, re.M)
    check(g is not None, f"{label}: rank 0 printed no data-parallel line:\n{printed[-3000:]}")
    launches = [tuple(int(x) for x in part.split(":")[1].split(","))
                for part in g.group(5).split()]
    return dict(export_s=export_seconds(printed), world=int(g.group(1)), backend=g.group(2),
                gather_s=float(g.group(3)), gather_bytes=int(g.group(4)), launches=launches)


EXPORT_ARRAYS = ("embeddings_all", "tokens_all", "weights_all")


def load_export(out_dir: Path) -> dict:
    import numpy as np

    return {name: np.load(out_dir / f"{name}.npy") for name in EXPORT_ARRAYS}


def differing(got: dict, want: dict) -> list[str]:
    """The export arrays of ``got`` that are not bitwise those of ``want``."""
    return [name for name in EXPORT_ARRAYS
            if got[name].dtype != want[name].dtype or got[name].shape != want[name].shape
            or got[name].tobytes() != want[name].tobytes()]


def dpx_world1(workdir: Path, n: int, one: dict) -> dict:
    """Phase 23 (a): ``torchrun --nproc-per-node 1 -m
    medtok_tpu_torch.cli.export --mesh-dp -1`` over NCCL on phase 18's
    workdir, unpacked and packed, each route's arrays bitwise phase 18's
    one-device arrays and its launches theirs."""
    import os

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    out = {}
    for route in ("off", "on"):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "medtok_tpu_torch.cli.export", "--workdir",
               str(workdir), "--mesh-dp", "-1", "--packed", route, "--out-dir",
               str(workdir / f"dp_{route}")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        label = f"data-parallel export (a) --packed {route}"
        check(run.returncode == 0, f"{label}: torchrun cli.export exited {run.returncode}:\n"
              f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        got = dpx_printed(run.stdout, label)
        check(got["world"] == 1 and got["backend"] == "nccl",
              f"{label}: world {got['world']} over {got['backend']}, want 1 over nccl")
        want = one[route]["launches"]
        check(got["launches"] == [(want["topk_l2"], want["segment_attention"])],
              f"{label}: launches {got['launches']}, the one-device run's {want}")
        differ = differing(load_export(workdir / f"dp_{route}"), one[route]["arrays"])
        check(not differ, f"{label}: {differ} differ from phase 18's one-device arrays")
        log(f"{label}: {n} codes, torchrun {wall:.3f} s wall, the export alone "
            f"{got['export_s']:.3f} s ({n / got['export_s']:.1f} codes/s; one device in "
            f"phase 18: {one[route]['export_s']:.3f} s, {n / one[route]['export_s']:.1f} "
            f"codes/s, {one[route]['wall_s']:.3f} s wall in process), the gather "
            f"{got['gather_s']:.3f} s for {got['gather_bytes']} bytes, launches (K1, K2) "
            f"{got['launches'][0]}; embeddings_all, tokens_all and weights_all bitwise "
            "equal to phase 18's")
        out[route] = dict(got, wall_s=wall)
    return out


def dpx_rank(rank: int, world: int, root: Path) -> int:
    """One rank of phase 23 (b), started by ``dpx_two_ranks``: a gloo group
    on the card shared with the other rank, then ``cli.export`` (packed,
    ``--mesh-dp -1``) on the workdir that ``root/spec.pkl`` names. Writes
    rank{rank}.pkl under root: the arrays returned, this rank's K1 and K2
    launches, what the CLI printed."""
    import pickle

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.cli import export as export_cli
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    torch.cuda.set_device(torch.device("cuda", 0))
    dist.init_process_group("gloo", init_method=f"file://{root / 'group'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    spec = pickle.loads((root / "spec.pkl").read_bytes())
    fused_topk_l2.launches = 0
    packed_segment_attention.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        arrays = export_cli.main(["--workdir", spec["workdir"], "--packed", "on",
                                  "--mesh-dp", "-1", "--out-dir", str(root / "out")])
    out = dict(arrays=arrays, printed=printed.getvalue(),
               launches=(fused_topk_l2.launches, packed_segment_attention.launches))
    (root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dpx_two_ranks(workdir: Path, n: int, one: dict, root: Path) -> dict:
    """Phase 23 (b): DPX_RANKS ranks share the card over gloo and run the
    packed export of phase 18's workdir: every rank's arrays and the files
    rank 0 wrote bitwise phase 18's one-device arrays, each rank's launches
    4 K1 and 12 K2 a step of its share."""
    import os
    import pickle

    root.mkdir(parents=True, exist_ok=True)
    (root / "spec.pkl").write_bytes(pickle.dumps({"workdir": str(workdir)}))
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), "--dp-world", str(DPX_RANKS), "--dp-root", str(root),
                               "--dp-task", "export"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(DPX_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    label = "data-parallel export (b)"
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{label}: rank {r} exited {p.returncode}:\n{text[-4000:]}")
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(DPX_RANKS)]
    got = dpx_printed(ranks[0]["printed"], label)
    check(got["world"] == DPX_RANKS and got["backend"] == "gloo",
          f"{label}: world {got['world']} over {got['backend']}")
    check(not any(r["printed"] for r in ranks[1:]), f"{label}: a rank other than 0 printed")
    differ = differing(load_export(root / "out"), one["on"]["arrays"])
    check(not differ, f"{label}: rank 0's files {differ} differ from phase 18's one-device "
          "arrays")
    for r, rank in enumerate(ranks):
        differ = differing(rank["arrays"], one["on"]["arrays"])
        check(not differ, f"{label}: rank {r}'s {differ} differ from phase 18's one-device "
              "arrays")
    # the one-device run's steps, K1 4 and K2 12 a step, split r, r + world, ...
    steps = one["on"]["launches"]["topk_l2"] // 4
    want = [(4 * len(range(r, steps, DPX_RANKS)), 12 * len(range(r, steps, DPX_RANKS)))
            for r in range(DPX_RANKS)]
    check([r["launches"] for r in ranks] == want == got["launches"],
          f"{label}: launches {[r['launches'] for r in ranks]} (printed {got['launches']}), "
          f"want {want} of {steps} steps")
    log(f"{label}: {DPX_RANKS} ranks sharing the card over gloo, packed, {n} codes: "
        f"{wall:.3f} s wall for both rank processes, the export alone {got['export_s']:.3f} "
        f"s ({n / got['export_s']:.1f} codes/s), the gather {got['gather_s']:.3f} s for "
        f"{got['gather_bytes']} bytes; {steps} steps, launches (K1, K2) by rank {want}; "
        "every rank's arrays and rank 0's files bitwise equal to phase 18's one-device "
        "export")
    return dict(got, wall_s=wall, steps=steps)


def run_dp_export(ehr_downstream: dict, n: int, keep: Path) -> dict:
    """Phase 23: the data-parallel export. (a) cli.export under torchrun at
    world size 1 over NCCL, both routes; (b) two gloo ranks sharing the
    card, packed; each bitwise phase 18's one-device arrays."""
    import gc

    import torch

    phase_t0 = time.perf_counter()
    # the rank processes share the card with this one
    gc.collect()
    torch.cuda.empty_cache()
    export = ehr_downstream["export"]
    workdir = export["workdir"]
    one = {route: dict(export[route], arrays=load_export(workdir / f"packed_{route}"))
           for route in ("off", "on")}
    out = {"world1": dpx_world1(workdir, n, one),
           "ranks": dpx_two_ranks(workdir, n, one, keep / "dpx")}
    log(f"data-parallel export: phase {time.perf_counter() - phase_t0:.2f} s")
    return out


# ----------------------------------------------------------- auxiliaries --

AUX_RANKS = 2           # ranks sharing the card over gloo in phase 24 (b) and (c)
AUX_ROWS = 4096         # z rows of phase 24 (b): the export's sweep
AUX_DROP = (1024, 128, 768)   # phase 24 (e)'s bf16 tensor
AUX_DROP_P = 0.1


def zero_launches() -> None:
    """Every kernel wrapper's launch counts to 0."""
    for f in kernel_wrappers().values():
        f.launches = 0
        if hasattr(f, "wide_launches"):
            f.wide_launches = 0


def run_examples(keep: Path) -> dict:
    """Phase 24 (a): examples/quickstart_torch.py and
    examples/downstream_torch.py on the card, each through its main() with
    its own checks, the kernel counts set to 0 just before each and read
    just after: K1 in the quickstart's training, export and API, K3 in the
    downstream's EHR encoder."""
    import importlib.util

    repo = Path(__file__).resolve().parent
    out = {}
    for name in ("quickstart_torch", "downstream_torch"):
        spec = importlib.util.spec_from_file_location(name, repo / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        printed = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = module.main(["--workdir", str(keep / name)])
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in kernel_launches().items() if n}
        out[name] = dict(result=result, launches=launches, wall_s=wall)
        tail = " | ".join(line.strip() for line in printed.getvalue().splitlines()[-4:])
        log(f"auxiliaries (a): examples/{name}.py on the card in {wall:.3f} s, launches "
            f"{launches}; its last lines: {tail}")
    q, d = out["quickstart_torch"], out["downstream_torch"]
    check(q["launches"].get("topk_l2", 0) > 0, f"quickstart: no K1 launch ({q['launches']})")
    check(q["result"]["api_diff"] <= 2e-3, f"quickstart: APIs differ by {q['result']['api_diff']}")
    check(all(d["launches"].get(f"flash_attention_{k}", 0) > 0 for k in ("fwd", "dq", "dkv")),
          f"downstream: a K3 kernel never ran ({d['launches']})")
    return out


def aux_ema_inputs(seed: int):
    """Phase 24 (b)'s inputs on the CPU, from ``seed``: ModelConfig()'s
    codebook as unit rows [21000, 64], z [AUX_ROWS, 64], a usage EMA, an
    embed_prob with the share of every 8th codeword 0."""
    import torch

    from medtok_tpu_torch.config import ModelConfig
    from medtok_tpu_torch.ops import ema, vq

    q = ModelConfig().quantizer
    g = torch.Generator().manual_seed(seed + 24)
    w = vq.l2_normalize(torch.randn(q.codebook_size, q.codebook_embed_dim, generator=g))
    z = torch.randn(AUX_ROWS, q.codebook_embed_dim, generator=g)
    cluster = torch.rand(q.codebook_size, generator=g)
    prob = torch.rand(q.codebook_size, generator=g) / q.codebook_size
    prob[::8] = 0.0
    return ema.embedding_ema_init(q.codebook_size, q.codebook_embed_dim, init_weight=w), \
        z, cluster, prob


def state_to(state, dev):
    return type(state)(*(t.to(dev) for t in state))


def k1_row_gaps(got, want, flat, weight) -> "np.ndarray":
    """The float64 distance gap, at each row where two top-1 index vectors
    differ, between the two picks."""
    import numpy as np

    rows = np.flatnonzero(got != want)
    f = flat.double().cpu().numpy()[rows]
    w = weight.double().cpu().numpy()
    dist = lambda idx: ((f - w[idx[rows]]) ** 2).sum(axis=1)  # noqa: E731
    return np.abs(dist(got) - dist(want))


def hold_ema(got, want, flat, weight, label: str, tol: float) -> str:
    """A card run of a stand-alone quantizer against the plain route's:
    indices equal but at rows whose two picks are tied within 1e-5; the
    updated codebook rows and usage entries within ``tol``, those touched
    by a differing row aside."""
    import numpy as np

    gi, wi = got.indices.cpu().numpy(), want.indices.cpu().numpy()
    gaps = k1_row_gaps(gi, wi, flat, weight)
    check(float(gaps.max(initial=0.0)) <= 1e-5,
          f"{label}: indices differ beyond a tie (gaps {sorted(gaps.tolist())[-5:]})")
    touched = np.zeros(weight.shape[0], bool)
    touched[gi[gi != wi]] = touched[wi[gi != wi]] = True
    w_err = float((got.state.weight.cpu() - want.state.weight)[~touched].abs().max())
    check(w_err <= tol, f"{label}: codebook error {w_err} > {tol}")
    c_err = 0.0
    if hasattr(got, "cluster_size"):
        c_err = float((got.cluster_size.cpu() - want.cluster_size)[~touched].abs().max())
        check(c_err <= tol, f"{label}: usage EMA error {c_err} > {tol}")
    l_err = abs(float(got.loss) - float(want.loss))
    check(l_err <= tol, f"{label}: loss error {l_err} > {tol}")
    return (f"{int((gi != wi).sum())}/{len(gi)} indices differ (max tie gap "
            f"{float(gaps.max(initial=0.0)):.3e}), codebook err {w_err:.3e}, usage err "
            f"{c_err:.3e}, loss err {l_err:.3e} ({int(touched.sum())} touched rows aside)")


def aux_norm_ema(dev, seed: int) -> dict:
    """Phase 24 (b), one device: norm_ema_quantize at ModelConfig()'s
    codebook width on the card (K1 at k = 1: one launch a call, counted
    from 0) in training and eval, each held to the plain route on the CPU;
    then revival_quantize with each anchor, the closest one held to the
    CPU within 1e-5. Returns the card's results (CPU copies) and the
    launches."""
    import torch

    from medtok_tpu_torch.ops import ema
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2

    state, z, cluster, prob = aux_ema_inputs(seed)
    flat = ema.l2_normalize(z)
    st_d, z_d, cl_d = state_to(state, dev), z.to(dev), cluster.to(dev)
    out = {}
    zero_launches()
    for train in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ema.norm_ema_quantize(z_d, st_d, cl_d, train=train)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = ema.norm_ema_quantize(z, state, cluster, train=train)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        summary = hold_ema(got, want, flat, state.weight, f"norm_ema_quantize train={train}",
                           1e-6)
        out[train] = got
        log(f"auxiliaries (b): norm_ema_quantize train={train}, z [{AUX_ROWS}, 64] against "
            f"{state.weight.shape[0]} x 64 on the card in {ms:.3f} ms (the CPU plain route "
            f"{cpu_ms:.3f} ms): {summary}")
    launches = fused_topk_l2.launches + fused_topk_l2.wide_launches
    check(fused_topk_l2.launches == 2 and fused_topk_l2.wide_launches == 0,
          f"norm_ema_quantize: K1 launches {fused_topk_l2.launches} (wide "
          f"{fused_topk_l2.wide_launches}), want 1 a call")
    pool = ema.feature_pool_init(state.weight.shape[0], 64,
                                 generator=torch.Generator(device=dev).manual_seed(seed),
                                 device=dev)
    for anchor in ema.ANCHORS:
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        got = ema.revival_quantize(z_d, st_d, prob.to(dev), pool, anchor=anchor,
                                   contras_loss=True, generator=g)
        torch.cuda.synchronize()
        fin = all(bool(torch.isfinite(t).all()) for t in (got.z_q, got.state.weight,
                                                          got.contra_loss, got.embed_prob))
        check(fin, f"revival_quantize {anchor}: non-finite outputs")
        note = ""
        if anchor == "closest":
            want = ema.revival_quantize(z, state, prob, ema.feature_pool_init(1, 64),
                                        anchor=anchor, contras_loss=True)
            note = "; against the CPU: " + hold_ema(got, want, flat, state.weight,
                                                   "revival_quantize closest", 1e-5)
            c_err = abs(float(got.contra_loss) - float(want.contra_loss))
            check(c_err <= 1e-5, f"revival_quantize closest: contrastive term error {c_err}")
        revived = int((got.state.weight - st_d.weight).norm(dim=1).gt(0.1).sum())
        log(f"auxiliaries (b): revival_quantize {anchor}: {revived} codewords moved by more "
            f"than 0.1, contrastive term {float(got.contra_loss):.4f}{note}")
    return {"train": out[True], "launches": launches}


def aux_zero_params(dev, seed: int):
    """ModelConfig()'s parameters in fp32 (the frozen BERT's too), random
    from ``seed`` on the card, a gradient for each, and the Adam state of a
    replicated step on them."""
    import torch

    from medtok_tpu_torch.config import ModelConfig
    from medtok_tpu_torch.models.layers import init_random_
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    g = torch.Generator(device=dev).manual_seed(seed + 24)
    model = init_random_(MultimodalTokenizer(ModelConfig(), param_dtype=torch.float32,
                                             device=dev), g)
    params = {k: v.detach().float() for k, v in model.named_parameters()}
    del model
    grads = {k: 1e-3 * torch.randn(v.shape, generator=g, device=dev) for k, v in params.items()}
    ps = [torch.nn.Parameter(v.clone()) for v in params.values()]
    opt = torch.optim.Adam(ps, lr=1e-4, foreach=False)
    for p, gr in zip(ps, grads.values()):
        p.grad = gr
    opt.step()
    opt_state = {k: opt.state[p] for k, p in zip(params, ps)}
    return params, grads, opt_state


def adam_step(params: dict, grads: dict) -> dict:
    """One Adam step (``foreach=False``) on copies of ``params`` (tensors or
    DTensors) with ``grads``; the new parameters."""
    import torch

    ps = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = torch.optim.Adam(list(ps.values()), lr=1e-4, foreach=False)
    for k, p in ps.items():
        p.grad = grads[k]
    opt.step()
    return {k: p.detach() for k, p in ps.items()}


def aux_zero(dp, seed: int) -> dict:
    """Phase 24 (c) on ``dp``: apply_zero at stages 0-3 on ModelConfig()'s
    parameters and Adam state (the bytes this rank holds at each), then one
    Adam step on the stage-3 DTensors against the replicated step; returns
    the bytes by stage and the largest difference of this rank's shards."""
    import torch

    from medtok_tpu_torch.utils import zero

    params, grads, opt_state = aux_zero_params(dp.device, seed)
    held = {}
    for stage in range(4):
        p, o = zero.apply_zero(stage, dp, params, opt_state)
        held[stage] = (zero.local_bytes(p), zero.local_bytes(o))
        del p, o
    p3 = zero.apply_zero(3, dp, params)
    g3 = zero.apply_zero(3, dp, grads)
    got = adam_step(p3, g3)
    want = adam_step(params, grads)
    err, bitwise = 0.0, True
    for k, t in got.items():
        local = t.to_local()
        dim = zero.dp_shard_spec(tuple(want[k].shape), dp.dp_size)
        ref = want[k] if dim is None else want[k].chunk(dp.dp_size, dim)[dp.rank]
        bitwise &= torch.equal(local, ref)
        err = max(err, float((local - ref).abs().max()))
    torch.cuda.synchronize(dp.device)
    return {"held": held, "err": err, "bitwise": bitwise,
            "total": (zero.local_bytes(params), zero.local_bytes(opt_state))}


def aux_rank_results(dp, seed: int) -> dict:
    """What one gloo rank of phase 24 computes on ``dp``: norm_ema_quantize
    with ``dp=`` on its part of the rows, then ``aux_zero``."""
    from medtok_tpu_torch.ops import ema

    state, z, cluster, _ = aux_ema_inputs(seed)
    mine = z.chunk(dp.world)[dp.rank].to(dp.device)
    o = ema.norm_ema_quantize(mine, state_to(state, dp.device), cluster.to(dp.device),
                              train=True, dp=dp)
    return {"indices": o.indices.cpu(), "weight": o.state.weight.cpu(),
            "cluster": o.cluster_size.cpu(), "zero": aux_zero(dp, seed)}


def aux_rank(rank: int, world: int, root: Path) -> int:
    """One rank of phase 24 (b) and (c), started by ``aux_two_ranks``: a
    gloo group on the card shared with the other rank, then
    ``aux_rank_results``, written to rank{rank}.pkl under root."""
    import pickle

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.parallel.mesh import DataParallel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{root / 'group'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    spec = pickle.loads((root / "spec.pkl").read_bytes())
    out = aux_rank_results(DataParallel(rank, world, dev), spec["seed"])
    (root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def hold_aux_ranks(ranks: list, one: dict) -> None:
    """Phase 24 (b) and (c)'s checks of the gloo ranks' results: the ranks'
    indices together one device's; codebook and usage EMA within 1e-6 of
    one device's on all rows; each rank's stage-3 shard within 1e-6 of the
    replicated step."""
    import torch

    idx = torch.cat([r["indices"] for r in ranks])
    check(torch.equal(idx, one["train"].indices.cpu()),
          "auxiliaries (b): the gloo ranks' indices differ from one device's")
    errs = [max(float((r["weight"] - one["train"].state.weight.cpu()).abs().max()),
                float((r["cluster"] - one["train"].cluster_size.cpu()).abs().max()))
            for r in ranks]
    check(max(errs) <= 1e-6, f"auxiliaries (b): gloo ranks against one device: {errs} > 1e-6")
    zerr = [r["zero"]["err"] for r in ranks]
    check(max(zerr) <= 1e-6, f"auxiliaries (c): gloo stage-3 step against replicated: {zerr}")
    log(f"auxiliaries (b): {len(ranks)} gloo ranks sharing the card, norm_ema_quantize on "
        f"{len(ranks[0]['indices'])} rows each: indices equal to one device's, codebook and "
        f"usage within {max(errs):.3e} of it on all rows")
    for r, rank in enumerate(ranks):
        z = rank["zero"]
        log(f"auxiliaries (c): gloo rank {r} of {len(ranks)}: bytes held (params, Adam "
            f"state) by stage {z['held']} of {z['total']}; the stage-3 step's shard within "
            f"{z['err']:.3e} of the replicated step (bitwise: {z['bitwise']})")


def aux_two_ranks(one: dict, seed: int, root: Path) -> dict:
    """Phase 24 (b) and (c) on AUX_RANKS gloo ranks sharing the card
    (``aux_rank`` processes), held by ``hold_aux_ranks``."""
    import os
    import pickle

    root.mkdir(parents=True, exist_ok=True)
    (root / "spec.pkl").write_bytes(pickle.dumps({"seed": seed}))
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), "--dp-world", str(AUX_RANKS), "--dp-root", str(root),
                               "--dp-task", "aux"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(AUX_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"auxiliaries, gloo rank {r} exited {p.returncode}:\n"
              f"{text[-4000:]}")
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(AUX_RANKS)]
    hold_aux_ranks(ranks, one)
    log(f"auxiliaries: the {AUX_RANKS} gloo rank processes took {wall:.3f} s wall")
    return {"wall_s": wall, "zero": [r["zero"] for r in ranks]}


def aux_world1(dev, one: dict, seed: int) -> dict:
    """Phase 24 (b) and (c) in a world-1 NCCL group joined here:
    norm_ema_quantize with the group bitwise equal to without it; apply_zero
    at stages 0-3 and the stage-3 Adam step bitwise equal to the replicated
    one."""
    import gc
    import os

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch.ops import ema
    from medtok_tpu_torch.parallel.mesh import initialize_distributed, warmup_collectives

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        dp = initialize_distributed(dev)
        warmup_collectives(dp)
        check(dp.backend == "nccl", f"auxiliaries: backend {dp.backend}, want nccl")
        state, z, cluster, _ = aux_ema_inputs(seed)
        got = ema.norm_ema_quantize(z.to(dev), state_to(state, dev), cluster.to(dev),
                                    train=True, dp=dp)
        want = one["train"]
        same = all(torch.equal(a, b) for a, b in zip(
            (got.indices, got.z_q, got.loss, got.cluster_size, *got.state),
            (want.indices, want.z_q, want.loss, want.cluster_size, *want.state)))
        check(same, "auxiliaries (b): norm_ema_quantize over the world-1 NCCL group differs "
              "from no group")
        t0 = time.perf_counter()
        zr = aux_zero(dp, seed)
        zero_s = time.perf_counter() - t0
        check(zr["bitwise"], f"auxiliaries (c): the world-1 NCCL stage-3 Adam step differs "
              f"from the replicated one by {zr['err']}")
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for key in env:
            os.environ.pop(key, None)
    log("auxiliaries (b): norm_ema_quantize over a world-1 NCCL group bitwise equal to no "
        "group")
    log(f"auxiliaries (c): world-1 NCCL, ModelConfig() in fp32: bytes held (params, Adam "
        f"state) by stage {zr['held']} of {zr['total']}; the stage-3 Adam step (foreach=False) "
        f"bitwise equal to the replicated step; {zero_s:.3f} s")
    return zr


def aux_profile(model_state: dict, buffers: dict, cfg, dataset, dev, keep: Path) -> dict:
    """Phase 24 (d): trace() and StepTimer around a packed export of the
    first two of phase 5's export steps (phase 5's model rebuilt from its
    weights), twice: the trace file holds the export.bert and
    export.quantize ranges and K1's and K2's kernels, counters.json the two
    exports' quantize.codes; the timer's summary is logged."""
    import json as json_module

    import numpy as np
    import torch

    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.export import export_all_packed, export_groups
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.utils.profiling import StepTimer, trace

    model = MultimodalTokenizer(cfg.model, device=dev).eval()
    model.load_state_dict(model_state)
    for name, buf in buffers.items():
        model.get_buffer(name).copy_(buf)
    first = sorted(int(i) for g in export_groups(dataset)[:2] for i in np.asarray(g).ravel())
    sub = MedCodeDataset(dataset.kg, [dataset.med_codes[i] for i in first],
                         [dataset.descs[i] for i in first],
                         [dataset.pkg_index_lists[i] for i in first],
                         dataset.tokenizer, cfg=dataset.cfg)
    sub.warm_cache()
    steps = len(export_groups(sub))
    timer = StepTimer()
    logdir = keep / "trace"
    with trace(logdir):
        for _ in range(2):
            timer.start(sync_on=torch.zeros(1, device=dev))
            arrays = export_all_packed(model, sub, device=dev)
            timer.stop(sync_on=torch.zeros(1, device=dev))
    files = list(logdir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"auxiliaries (d): trace files {files}")
    moved = json_module.loads((logdir / "counters.json").read_text())
    check(moved.get("quantize.code_slots", 0) >= moved.get("quantize.codes", 0) == 2 * len(sub),
          f"auxiliaries (d): counters.json {moved}")
    names = {e.get("name", "") for e in json_module.loads(files[0].read_text())["traceEvents"]}
    for want in ("export.bert", "export.quantize"):
        check(want in names, f"auxiliaries (d): no {want} range in the trace")
    for kernel in ("topk_tf32_kernel", "segment_attention_mma_kernel"):
        check(any(kernel in n for n in names), f"auxiliaries (d): no {kernel} in the trace")
    check(bool(np.isfinite(arrays["embeddings_all"]).all()), "auxiliaries (d): non-finite")
    summary = timer.summary()
    log(f"auxiliaries (d): trace of {len(sub)} codes ({steps} packed export steps) twice: "
        f"{files[0].stat().st_size / 2**20:.1f} MiB, export.bert / export.quantize ranges "
        f"and K1's / K2's kernels in it; StepTimer {summary}")
    return summary


def aux_drop_path(dev, seed: int) -> dict:
    """Phase 24 (e): drop_path on a CUDA [1024, 128, 768] bf16 tensor at p
    0.1: the kept samples exactly x * (1 / keep) in bf16, the dropped ones
    0, the dropped share within 4 sigma of p."""
    import torch

    from medtok_tpu_torch.ops.drop_path import drop_path

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*AUX_DROP, generator=g, device=dev, dtype=torch.bfloat16)
    out = drop_path(x, AUX_DROP_P, generator=g)
    kept = (out != 0).flatten(1).any(dim=1)
    scale = torch.ones((), dtype=torch.bfloat16, device=dev) / torch.tensor(
        1 - AUX_DROP_P, dtype=torch.bfloat16, device=dev)
    check(torch.equal(out[kept], x[kept] * scale), "drop_path: kept samples not scaled exactly")
    check(not out[~kept].any(), "drop_path: a dropped sample is not zero")
    share = 1.0 - float(kept.float().mean())
    sigma = (AUX_DROP_P * (1 - AUX_DROP_P) / AUX_DROP[0]) ** 0.5
    check(abs(share - AUX_DROP_P) <= 4 * sigma,
          f"drop_path: dropped share {share} beyond 4 sigma ({sigma}) of {AUX_DROP_P}")
    ms = cuda_ms(lambda: drop_path(x, AUX_DROP_P, generator=g), 20)
    log(f"auxiliaries (e): drop_path on [{', '.join(map(str, AUX_DROP))}] bf16 at p "
        f"{AUX_DROP_P}: dropped share {share:.4f} (4 sigma {4 * sigma:.4f}), kept samples "
        f"exactly x * {float(scale)}; {ms:.4f} ms a call")
    return {"share": share, "ms": ms}


def run_auxiliaries(model_state: dict, buffers: dict, cfg, dataset, dev, seed: int,
                    keep: Path) -> dict:
    """Phase 24: the auxiliaries on the card, (a)-(e)."""
    import gc

    import torch

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"examples": run_examples(keep / "examples")}
    out["ema"] = aux_norm_ema(dev, seed)
    out["world1"] = aux_world1(dev, out["ema"], seed)
    gc.collect()
    torch.cuda.empty_cache()
    out["ranks"] = aux_two_ranks(out["ema"], seed, keep / "aux")
    out["profile"] = aux_profile(model_state, buffers, cfg, dataset, dev, keep)
    out["drop_path"] = aux_drop_path(dev, seed)
    log(f"auxiliaries: phase {time.perf_counter() - phase_t0:.2f} s")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--codes", type=int, default=16384)
    # one rank of phase 21 (d), started by the phase itself
    p.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp-world", type=int, default=DP_RANKS, help=argparse.SUPPRESS)
    p.add_argument("--dp-root", type=str, default=None, help=argparse.SUPPRESS)
    # its task: phase 21 (d)'s training, phase 23 (b)'s export, or phase 24's
    # norm-EMA and ZeRO step
    p.add_argument("--dp-task", default="train", choices=["train", "export", "aux"],
                   help=argparse.SUPPRESS)
    # one rank of phase 22, started by the phase itself
    p.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--tp-world", type=int, default=TP_RANKS, help=argparse.SUPPRESS)
    p.add_argument("--tp-root", type=str, default=None, help=argparse.SUPPRESS)
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
    if args.dp_rank is not None:
        rank_fn = {"export": dpx_rank, "aux": aux_rank}.get(args.dp_task, dp_rank)
        return rank_fn(args.dp_rank, args.dp_world, Path(args.dp_root))
    if args.tp_rank is not None:
        return tp_rank(args.tp_rank, args.tp_world, Path(args.tp_root))
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
    dataset_np = numpy_route(dataset)
    check_numpy_route_export(model, dataset_np, dev, arrays)
    check_reference(model, dataset, dev)
    serve_requests(cfg, model, dataset, dev)
    # phase 18 exports this model again in fp32 through the export CLI
    model_state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    buffers = {k: v.cpu() for k, v in model.named_buffers() if k not in model_state}
    del model

    # the export's embeddings_all is the EHR model's frozen code table
    table = arrays["embeddings_all"]
    ehr = build_ehr_data(args.seed, table.shape[0], batch=256)
    k3 = check_k3(gen, dev, key_mask_of(ehr["val"][0], dev))
    k3_launches, trainer = run_ehr(table, ehr, dev)
    check_ehr_reference(trainer, ehr, dev)
    del trainer
    check_ehr_heads(table, ehr, dev)
    wide_paths = check_wide_paths(table, ehr, dataset, dev, gen)
    check_small_export(dataset, dev, gen)
    slice3 = run_slice3()
    train_launches = run_training(dataset, dataset_np, dev, gen)
    check_train_reference(dataset, dev)
    log(f"training launches: {train_launches}")
    import shutil
    import tempfile

    keep = Path(tempfile.mkdtemp(prefix="medtok_cli_"))
    clis = run_clis(args.seed, dev, keep)
    run_qa(table, dev, args.seed)
    ehr_downstream = run_ehr_downstream(model_state, buffers, cfg, dataset, table, args.seed,
                                        dev, keep)
    run_host_runtime(dataset, dataset_np, dev, args.seed)
    variants = run_training_variants(dataset, dev, gen)
    try:
        dp = run_data_parallel(dataset, table, ehr, dev, gen, keep, clis["argv"], args.seed)
        tp = run_tensor_parallel(dataset, table, dev, args.seed, keep / "tp")
        dpx = run_dp_export(ehr_downstream, len(dataset), keep)
        aux = run_auxiliaries(model_state, buffers, cfg, dataset, dev, args.seed, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    k1["launches"] = launches["topk_l2"]
    k2["launches"] = launches["segment_attention"]
    for row, key in zip(k3, ("fwd", "dq", "dkv")):
        row["launches"] = k3_launches[key]
    for row in (k4, *k5):
        row["launches"] = slice3[row["name"]]
    # the kernels on phase 18's paths, with their launches there
    k1["launches_by_path"] = {
        "export (phase 5)": launches["topk_l2"],
        "cli.export --packed off (phase 18)":
            ehr_downstream["export"]["off"]["launches"]["topk_l2"]}
    k2["launches_by_path"] = {"export (phase 5)": launches["segment_attention"]}
    # phase 20's paths: the GAT + kmeans + revival run and its export, and
    # the text-dropout run (its BERT is dense: no K2)
    for label, key in (("cli.train GAT + kmeans + revival (phase 20)", "train"),
                       ("cli.export --workdir of it (phase 20)", "export"),
                       ("cli.train --text-dropout-in-train (phase 20)", "dropout")):
        k1["launches_by_path"][label] = variants[key]["launches"]["topk_l2"]
        k2["launches_by_path"][label] = variants[key]["launches"]["segment_attention"]
    # phase 21's paths: the world-1 NCCL step, and each of the two gloo ranks
    k1["launches_by_path"]["data-parallel step, world-1 NCCL (phase 21 b)"] = \
        dp["step"]["launches"]["topk_l2"]
    k2["launches_by_path"]["data-parallel step, world-1 NCCL (phase 21 b)"] = \
        dp["step"]["launches"]["segment_attention"]
    k1["launches_by_path"]["data parallel, a gloo rank of 2 (phase 21 d)"] = \
        dp["ranks"]["launches"]["topk_l2"]
    k2["launches_by_path"]["data parallel, a gloo rank of 2 (phase 21 d)"] = \
        dp["ranks"]["launches"]["segment_attention"]
    # phase 23's paths: the world-1 NCCL export CLI, each gloo rank's share
    for route, what in (("off", "unpacked"), ("on", "packed")):
        k1_n, k2_n = dpx["world1"][route]["launches"][0]
        path = f"cli.export --mesh-dp -1 {what}, world-1 NCCL (phase 23 a)"
        k1["launches_by_path"][path] = k1_n
        if k2_n:
            k2["launches_by_path"][path] = k2_n
    for r, (k1_n, k2_n) in enumerate(dpx["ranks"]["launches"]):
        path = f"cli.export --mesh-dp -1 packed, gloo rank {r} of {DPX_RANKS} (phase 23 b)"
        k1["launches_by_path"][path] = k1_n
        k2["launches_by_path"][path] = k2_n
    # phase 22's path: the tensor-parallel sweep on each gloo rank
    for t, n in enumerate(tp["launches"]):
        k1["launches_by_path"][
            f"tensor-parallel sweep, gloo rank {t} of {TP_RANKS} (phase 22 a)"] = n
    # phase 24's paths: the examples, and the stand-alone norm-EMA quantizer
    quick = aux["examples"]["quickstart_torch"]["launches"]
    down = aux["examples"]["downstream_torch"]["launches"]
    k1["launches_by_path"]["examples/quickstart_torch.py (phase 24 a)"] = quick["topk_l2"]
    k2["launches_by_path"]["examples/quickstart_torch.py (phase 24 a)"] = \
        quick.get("segment_attention", 0)
    k1["launches_by_path"][
        "norm_ema_quantize, 21000 x 64, z [4096, 64], train + eval (phase 24 b)"] = \
        aux["ema"]["launches"]
    for row, key in zip(k3, ("fwd", "dq", "dkv")):
        row["launches_by_path"] = {"EHRTrainer.fit + evaluate (phase 8)": k3_launches[key],
                                   "cli.ehr (phase 18)": ehr_downstream["cli"]["k3"][key],
                                   "EHRTrainer, world-1 NCCL (phase 21 c)":
                                       dp["ehr"]["counts"][key],
                                   "EHRTrainer, a gloo rank of 2 (phase 21 d)":
                                       dp["ranks"]["k3"][key],
                                   "examples/downstream_torch.py (phase 24 a)":
                                       down[f"flash_attention_{key}"]}
    for row in wide:
        if row["name"] in wide_paths:
            row["launches_by_path"] = wide_paths[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    log(card)
    log(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                for k in (k1, k2, *k3, k4, *k5, *wide)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
