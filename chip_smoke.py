#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (medtok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--codes 16384]

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit, torch and CUDA);
  2. build the CUDA kernels from medtok_tpu_torch/csrc/ with nvcc;
  3. hold kernel K1 (top-k codebook sweep) against its plain version at the
     export shapes (4096 x 21000 and the 7000-row region), with a tie case;
  4. hold kernel K2 (packed segment attention) against its plain version at
     [256, 12, 128, 64] in fp32 and bf16 on a real packing layout;
  5. run the packed full-vocabulary export at the full ModelConfig() width
     (bert-base, 130K-node GCN, 21000 x 64 codebook, bf16) over a synthetic
     heavy-tail vocabulary, counting kernel launches, and hold a small fp32
     export with kernels against the plain versions on the CPU;
  6. answer tokenize / encode / embed requests for three codes.
It then prints the card, one JSON line of kernel measurements and, last,
{"ok": true, "device": {...}}. Without CUDA, or without the repository
beside it, it exits non-zero and prints no result. fp32 matmuls and
convolutions run in full fp32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s. The bound of a kernel is the larger of its bytes
# over the memory rate and its operations over the peak for their type.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

K = 5
D = 64


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

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- K1 --

def check_k1(gen, dev) -> dict:
    import torch

    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2, fused_topk_l2_reference

    def unit(*shape):
        return vq.l2_normalize(torch.randn(*shape, generator=gen, device=dev))

    B, N = 4096, 21000
    z, cb = unit(B, D), unit(N, D)
    result = {}
    for label, e in (("full", cb), ("region", vq.region_slice(cb, "graph"))):
        vals, idx = fused_topk_l2(z, e, k=K)
        torch.cuda.synchronize()
        pv, pi = vq.topk_smallest(vq.squared_distance(z, e), K + 1)
        gaps = pv[:, 1:] - pv[:, :-1]                  # [B, K]
        clean = (gaps > 1e-5).all(dim=1)               # no near tie anywhere
        boundary_ok = gaps[:, K - 1] > 1e-5            # no tie at the k-th
        check(torch.equal(idx[clean].long(), pi[clean, :K]),
              f"K1 {label}: indices differ from the plain version on clean rows")
        same_set = (torch.sort(idx.long(), dim=1).values
                    == torch.sort(pi[:, :K], dim=1).values).all(dim=1)
        check(bool(same_set[boundary_ok].all()),
              f"K1 {label}: index sets differ where the k-th gap exceeds 1e-5")
        ordered = (idx.long() == pi[:, :K]).all(dim=1)
        err = float((vals - pv[:, :K]).abs().max())
        check(err <= 1e-5, f"K1 {label}: value error {err} > 1e-5")
        log(f"K1 {label} B={B} N={e.shape[0]}: {int(clean.sum())}/{B} rows "
            f"without near ties identical, {int(boundary_ok.sum())} rows with "
            f"the boundary gap > 1e-5 set-equal ({int(ordered[boundary_ok].sum())} "
            f"of them in the same order), {int(ordered.sum())}/{B} rows identical "
            f"overall, max |value err| {err:.3e}")
        result[label] = dict(err=err, n=e.shape[0])

    # exact ties: every codeword twice -> the lower copy ranks first
    N0 = N // 2
    base = unit(N0, D)
    e = torch.cat([base, base])
    vals, idx = fused_topk_l2(z, e, k=K)
    idx = idx.long()
    check(bool((idx[:, 1] == idx[:, 0] + N0).all() and (idx[:, 3] == idx[:, 2] + N0).all()
               and (idx[:, [0, 2, 4]] < N0).all()),
          "K1 ties: duplicated rows not ranked lowest index first")
    check(bool((vals[:, 0] == vals[:, 1]).all() and (vals[:, 2] == vals[:, 3]).all()),
          "K1 ties: duplicated rows gave different distances")
    pv, pi = vq.topk_smallest(vq.squared_distance(z, base), 4)
    clean = ((pv[:, 1:] - pv[:, :-1]) > 1e-5).all(dim=1)
    check(torch.equal(idx[clean][:, [0, 2, 4]], pi[clean, :3]),
          "K1 ties: winners differ from the plain version")
    log(f"K1 ties: {B} rows lowest-index-first over {2 * N0} duplicated rows")

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
    bound_ms = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    log(f"K1 B={B} N={N}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library matmul+topk {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({ops / 1e9:.2f} GFLOP fp32); region N={N // 3}: kernel {region_ms:.4f} ms")
    return dict(name="topk_l2", route="cuda",
                source="medtok_tpu_torch/csrc/topk_l2.cu",
                replaces="medtok_tpu/ops/vq_pallas.py:139",
                max_abs_err=result["full"]["err"], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if ops / PEAK_FP32 > nbytes / PEAK_BYTES else "bytes",
                library_ms=library_ms)


# --------------------------------------------------------------------- K2 --

def check_k2(gen, dev, dataset) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from medtok_tpu_torch.export import export_groups, packed_layout
    from medtok_tpu_torch.ops.flash_attention import (
        packed_segment_attention,
        packed_segment_attention_reference,
    )

    row_len, num_rows, _ = packed_layout(dataset)
    group = export_groups(dataset)[0]
    # 80% of a full group: a real greedy layout whose last rows stay empty
    _, base, lens = dataset.pack_text_rows(group[: int(0.8 * len(group))],
                                           row_len=row_len, num_rows=num_rows)
    seg_np = np.zeros(num_rows * row_len, np.int32)
    for c, (b, n) in enumerate(zip(base.tolist(), lens.tolist())):
        seg_np[b:b + n] = c + 1
    seg = torch.from_numpy(seg_np.reshape(num_rows, row_len)).to(dev)
    pad = seg == 0
    check(bool(pad.all(dim=1).any()), "K2 layout has no all-padding row")
    R, H, P, Dh = num_rows, 12, row_len, 64
    q32, k32, v32 = (torch.randn(R, H, P, Dh, generator=gen, device=dev) for _ in range(3))

    out = packed_segment_attention(q32, k32, v32, seg)
    ref = packed_segment_attention_reference(q32, k32, v32, seg)
    err32 = float((out - ref).abs().max())
    check(err32 <= 1e-5, f"K2 fp32: max error {err32} > 1e-5")
    check(bool((out.transpose(1, 2)[pad] == 0).all()), "K2 fp32: padding rows not 0")

    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    out = packed_segment_attention(q, k, v, seg)
    ref = packed_segment_attention_reference(q.float(), k.float(), v.float(), seg)
    err16 = float((out.float() - ref).abs().max())
    check(out.dtype == torch.bfloat16, "K2 bf16: output dtype")
    check(err16 <= 2e-2, f"K2 bf16: max error {err16} > 2e-2")
    check(bool((out.transpose(1, 2)[pad] == 0).all()), "K2 bf16: padding rows not 0")
    log(f"K2 [{R},{H},{P},{Dh}]: fp32 max err {err32:.3e}, bf16 max err "
        f"{err16:.3e} vs fp32 plain, {int(pad.all(dim=1).sum())} all-padding rows")

    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    kernel_ms = cuda_ms(lambda: packed_segment_attention(q, k, v, seg), 20)
    plain_ms = cuda_ms(lambda: packed_segment_attention_reference(q, k, v, seg), 5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20)
    seg_sizes = torch.bincount(seg.flatten())[1:].double()
    ops = 4.0 * H * Dh * float((seg_sizes ** 2).sum())   # QK^T and PV per segment
    nbytes = 4.0 * R * H * P * Dh * 2 + R * P * 4
    bound_ms = max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"K2 bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"sdpa+mask {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP in-segment)")
    return dict(name="segment_attention", route="cuda",
                source="medtok_tpu_torch/csrc/segment_attention.cu",
                replaces="medtok_tpu/ops/flash_attention.py:740",
                max_abs_err=err16, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if ops / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes",
                library_ms=library_ms)


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

    def dev_us(e):
        return e.self_device_time_total

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = export_all_packed(model, dataset, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for name, arr in first.items():
        check(np.array_equal(arr, again[name]), f"a second export changed {name}")
    on_gpu = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    ranges = [e for e in events if e.key.startswith("export.")]
    device = [e for e in events if e.device_type == on_gpu and e not in ranges]
    copies = sum(dev_us(e) for e in device if e.key.startswith("Memcpy"))
    kernels = sum(dev_us(e) for e in device if not e.key.startswith("Memcpy"))
    log(f"profile: second export {wall:.3f} s wall under the profiler (bitwise "
        f"equal to the first); device kernels {kernels / 1e6:.3f} s "
        f"({100 * kernels / 1e6 / wall:.1f}% of wall), copies {copies / 1e6:.3f} s")
    for e in sorted(ranges, key=lambda e: (e.device_type == on_gpu, e.key)):
        side = "gpu span" if e.device_type == on_gpu else "host"
        t = dev_us(e) if e.device_type == on_gpu else e.cpu_time_total
        log(f"  {e.key:18s} {side:8s} {t / 1e6:8.3f} s  calls {e.count}")
    for e in sorted(device, key=lambda e: -dev_us(e))[:10]:
        log(f"  device {dev_us(e) / 1e3:9.2f} ms x{e.count:<5d} {e.key[:100]}")


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


def check_reference(model, dataset, dev, n_codes: int = 64) -> None:
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
    check(max_gap <= 1e-5, f"fp32 reference: token rows differ beyond a tie "
          f"(gaps {gaps.tolist()} > 1e-5)")
    check(emb_err <= 1e-4, f"fp32 reference: embedding error {emb_err} > 1e-4")
    log(f"fp32 reference ({n_codes} codes, kernels on the card vs plain on the "
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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    k1 = check_k1(gen, dev)

    t0 = time.perf_counter()
    dataset = build_dataset(args.seed, args.codes)
    dataset.warm_cache()
    log(f"data: {len(dataset)} codes, KG {dataset.kg.num_nodes} nodes / "
        f"{len(dataset.kg.edge_src)} edges, built in {time.perf_counter() - t0:.2f} s")

    k2 = check_k2(gen, dev, dataset)

    from medtok_tpu_torch.config import MedTokConfig, ModelConfig
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer, init_random_

    cfg = MedTokConfig(model=ModelConfig(), data=dataset.cfg)
    model = init_random_(MultimodalTokenizer(cfg.model, device=dev), gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: ModelConfig() {n_params / 1e6:.1f} M parameters, {cfg.model.compute_dtype}")

    launches, arrays = run_main_path(model, dataset, dev)
    profile_main_path(model, dataset, dev, arrays)
    check_reference(model, dataset, dev)
    serve_requests(cfg, model, dataset, dev)

    k1["launches"] = launches["topk_l2"]
    k2["launches"] = launches["segment_attention"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{key: k[key] for key in keys} for k in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
