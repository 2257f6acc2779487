"""A tiny DeepSeek-V2 MedTok for the CPU tests (``test_torch_dsv2_*.py``):
the ``medtok-dsv2lite`` configuration's keys at small widths (hidden 64, one
dense and two MoE layers of 8 experts, top-3, 2 shared, latent 16, nope 16,
rope 8, v 16, 4 heads, YaRN on with its ramp inside the rope pairs), fp32
compute, seeded weights named as the port's state_dict, and the
benchmark's corpus at a small size."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from medtok_tpu_torch.config import DeepseekV2TextConfig, MedTokConfig

REPO = Path(__file__).resolve().parent.parent

TEXT = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=96,
            kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
            num_experts_per_tok=3, first_k_dense_replace=1, rope_factor=4.0,
            rope_original_max_position=256)


def text_config() -> DeepseekV2TextConfig:
    return DeepseekV2TextConfig(**TEXT)


def model_config() -> dict:
    """The configuration file's model and data blocks at the tiny size."""
    cfg = json.loads((REPO / "portbench" / "configs" / "medtok-dsv2lite.json").read_text())
    m = cfg["model"]
    m["text"].update(TEXT)
    m["graph"].update(num_nodes=300, in_channels=8, hidden_channels=16, out_channels=16)
    m["quantizer"].update(codebook_size=90, codebook_embed_dim=16, usage_buffer_size=4096)
    m["compute_dtype"] = "float32"
    cfg["data"].update(text_buckets=[8, 16, 32, 64], node_buckets=[4, 16, 32],
                       edge_buckets=[16, 64, 256])
    return {"model": m, "data": cfg["data"]}


def medtok_config(**train) -> MedTokConfig:
    return MedTokConfig.from_dict({**model_config(), "train": train})


def weights(spec, seed: int = 0) -> dict[str, torch.Tensor]:
    """fp32 weights of a ``param_spec`` from one generator: N(0, 1/fan_in) by
    the last axis, N(0, 1) for the codebook, glorot for attention vectors,
    zero biases, unit scales."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, family in spec:
        if family in ("zero", "one"):
            out[name] = torch.full(shape, float(family == "one"))
        else:
            std = {"fan_in": 1 / math.sqrt(shape[-1]), "unit": 1.0,
                   "glorot": math.sqrt(2 / sum(shape))}[family]
            out[name] = torch.randn(shape, generator=gen) * std
    return out


def corpus(seed: int = 7):
    from portbench.datagen import make_corpus

    spec = json.loads((REPO / "portbench" / "traffic" / "export-dsv2.json").read_text())["corpus"]
    spec.update(seed=seed, codes=96, kg_nodes=300, extra_words=20)
    spec["nodes"].update(max_small=4, tiers=[[0.09, 5, 16], [0.03, 17, 32]])
    spec["kg"].update(edges=3000, local_window=8)
    return make_corpus(spec)


def dataset(corp, cfg: MedTokConfig, **kw):
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer

    kg = KnowledgeGraph(corp.kg_src, corp.kg_dst, corp.kg_rel, {}, corp.num_nodes)
    return MedCodeDataset(kg, corp.med_codes, corp.descs, corp.node_lists,
                          WordPieceTokenizer(corp.vocab), cfg=cfg.data, **kw)


def text_dict() -> dict:
    return dataclasses.asdict(text_config())


def padded_ids(seed: int, lens: list[int], L: int, vocab: int = 256):
    """Random token ids [B, L] with the given real lengths, and their mask."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (len(lens), L), generator=gen)
    mask = torch.arange(L)[None] < torch.tensor(lens)[:, None]
    return torch.where(mask, ids, 0), mask


def relative_rows(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    """Per row: |got - want| / |want| (L2 over the last axis)."""
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)).detach().numpy()
