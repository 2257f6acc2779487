"""Split the packed BERT forward at the export shape (R=256 rows of P=128)
into its parts (counterpart of ``scripts/profile_bert.py``).

Legs, each a function of a running scalar ``carry`` that adds the sum of
its output (so every leg ends in one reduction, as in the JAX script):

  full              encode_text_packed with the [R, P, P] pairwise mask
                    (dense attention, 12 layers)
  full_flash        encode_text_packed with segment ids (kernel K2)
  embed_ln          the word + position embedding lookups
  qkvo_ffn          the layer GEMMs alone (x @ Wqkv, @ Wo, @ W1, @ W2), 12x
  attn_core_fp32    QK^T -> mask -> softmax -> AV on fp32 logits, 12x
  attn_core_bf16    the same on bf16 logits
  ln_gelu           the two LayerNorm-style reductions and the exact gelu, 12x
  kernel_only       K2 ([R, NH, P, Dh]) 12x
  kernel_nt_only    K4 ([R, P, NH, Dh], no head transposes) 12x
  dense_core_only   the dense masked attention of kernel_only's shapes, 12x

The model is ``ModelConfig()`` with ``init_random_`` weights from a
``torch.Generator``; ids, segments and the synthetic bf16 weights and
activations come from numpy ``default_rng(7)`` (the JAX script also draws
its init batch from that stream; here the weights come from the
generator). Each leg runs once to warm up, with its kernel launches
counted, then ``--trials`` times ``--reps`` calls; a leg's time is the least
per-call time over the trials after the first (CUDA events on the card,
the host clock on the CPU). ``gemm_roofline_ms`` is the layer GEMMs'
operations over the H100's dense bf16 peak.

    python -m medtok_tpu_torch.scripts.profile_bert [--rows 256] [--len 128]
        [--reps 8] [--trials 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.config import ModelConfig
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.ops.flash_attention import (
    packed_segment_attention,
    packed_segment_attention_nt,
)
from medtok_tpu_torch.scripts import timed

# H100 SXM dense bf16 tensor-core peak, FLOP/s (NVIDIA data sheet)
PEAK_BF16 = 989e12
KERNELS = {"segment_attention": packed_segment_attention,
           "segment_attention_nt": packed_segment_attention_nt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--len", type=int, default=128)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    R, P = args.rows, args.len
    if P % 8:
        raise ValueError(f"--len {P} must be a multiple of 8 (8 segments per row)")
    if args.trials < 2 or args.reps < 1:
        raise ValueError("--trials must be at least 2 (the first is dropped), --reps >= 1")

    cfg = ModelConfig()
    tc = cfg.text
    H, I, NH = tc.hidden_size, tc.intermediate_size, tc.num_heads
    Dh = H // NH
    NL = tc.num_layers
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_random_(MultimodalTokenizer(cfg, device=dev), gen).eval()
    text = model.text_model
    rng = np.random.default_rng(7)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    ids = t(rng.integers(1, 20000, (R, P)), torch.int32)
    seg = t(np.repeat(np.arange(1, 9)[None, :], P // 8, axis=1).reshape(1, P)
            * np.ones((R, 1), np.int32), torch.int32)
    pm = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    pos = t(np.tile(np.arange(P) % 16, (R, 1)), torch.int32)

    def w(*shape):
        return t(rng.standard_normal(shape) * 0.02, bf)

    Wqkv, Wo, W1, W2 = w(NL, H, 3 * H), w(NL, H, H), w(NL, H, I), w(NL, I, H)
    x0 = t(rng.standard_normal((R, P, H)), bf)
    qh = t(rng.standard_normal((R, NH, P, Dh)) * 0.3, bf)
    qn = t(rng.standard_normal((R, P, NH, Dh)) * 0.3, bf)

    def total(carry, x):
        return carry + x.float().sum()

    def full(carry):
        return total(carry, model.encode_text_packed(ids, pm, pos))

    def full_flash(carry):
        return total(carry, model.encode_text_packed(ids, seg, pos))

    def embed_ln(carry):
        x = text.word_embeddings(ids.long()) + text.position_embeddings(pos.long())
        return total(carry, x.to(bf))

    def qkvo_ffn(carry):
        x = x0
        for layer in range(NL):
            q = (x @ Wqkv[layer])[..., :H]
            x = ((q @ Wo[layer]) @ W1[layer]) @ W2[layer]
        return total(carry, x)

    def attn_once(x, acc_dtype):
        q = x.view(R, P, NH, Dh).transpose(1, 2)
        logits = torch.matmul(q.to(acc_dtype), q.to(acc_dtype).transpose(-1, -2)) / math.sqrt(Dh)
        logits = torch.where(pm[:, None], logits, -1e9)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(attn, q).transpose(1, 2).reshape(R, P, H)

    def attn_core(acc_dtype):
        def leg(carry):
            x = x0
            for _ in range(NL):
                x = x + 0.001 * attn_once(x, acc_dtype)
            return total(carry, x)
        return leg

    def ln_gelu(carry):
        x = x0
        for _ in range(NL):
            m = x.mean(-1, keepdim=True)
            v = ((x - m) ** 2).mean(-1, keepdim=True)
            x = (x - m) * torch.rsqrt(v + 1e-12)
            h = F.gelu((x @ W1[0]).to(bf))
            x = x + 0.0 * h[..., :1]
            x = x - x.mean(-1, keepdim=True)
        return total(carry, x)

    def kernel_only(carry):
        x = qh
        for _ in range(NL):
            x = packed_segment_attention(x, x, x, seg)
        return total(carry, x)

    def kernel_nt_only(carry):
        x = qn
        for _ in range(NL):
            x = packed_segment_attention_nt(x, x, x, seg)
        return total(carry, x)

    def dense_core_only(carry):
        x = qh
        for _ in range(NL):
            logits = torch.matmul(x.float(), x.float().transpose(-1, -2)) / math.sqrt(Dh)
            logits = torch.where(pm[:, None], logits, -1e9)
            x = torch.matmul(torch.softmax(logits, dim=-1).to(x.dtype), x)
        return total(carry, x)

    legs = {"full": full, "full_flash": full_flash, "embed_ln": embed_ln,
            "qkvo_ffn": qkvo_ffn, "attn_core_fp32": attn_core(torch.float32),
            "attn_core_bf16": attn_core(bf), "ln_gelu": ln_gelu,
            "kernel_only": kernel_only, "kernel_nt_only": kernel_nt_only,
            "dense_core_only": dense_core_only}

    def chain(fn) -> tuple[float, dict]:
        """(least ms per call over the trials after the first, kernel
        launches of the warm-up call)."""
        before = {name: k.launches for name, k in KERNELS.items()}
        float(fn(torch.zeros((), device=dev)))
        launches = {name: k.launches - before[name] for name, k in KERNELS.items()}

        def reps():
            carry = torch.zeros((), device=dev)
            for _ in range(args.reps):
                carry = fn(carry)
            return carry

        # the first trial is timed()'s warm-up call
        return timed(reps, args.trials - 1, dev) / args.reps, launches

    out = {"shape": f"R={R} P={P} bf16",
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    launches = {}
    with torch.inference_mode():
        for name, fn in legs.items():
            out[f"{name}_ms"], launches[name] = chain(fn)
    gemm_flops = R * P * NL * (8 * H * H + 4 * H * I)
    out["gemm_roofline_ms"] = 1e3 * gemm_flops / PEAK_BF16
    out["gemm_peak_flops"] = PEAK_BF16
    out["launches_per_call"] = launches
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
