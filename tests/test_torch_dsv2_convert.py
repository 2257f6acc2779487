"""Weights into the DeepSeek-V2 text encoder: a HuggingFace DeepSeek-V2
state_dict (``model.layers.{i}.self_attn.kv_a_proj_with_mqa``, ``mlp.gate``,
``mlp.experts.{e}.*``, ``mlp.shared_experts.*``) through
``convert.convert_hf_deepseek_v2`` on a seeded synthetic one, and the
export CLI's ``--config`` / ``--params`` route with the encoder, against
``export_all_packed`` on the same model."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch import nn

from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.config import DataConfig, MedTokConfig, ModelConfig
from medtok_tpu_torch.convert import convert_hf_deepseek_v2, save_npz
from medtok_tpu_torch.data.dataset import MedCodeDataset, write_jsonl
from medtok_tpu_torch.data.kg import KnowledgeGraph
from medtok_tpu_torch.data.synthetic import MEDICAL_WORDS, SYLLABLES, synthetic_vocab_columns
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.export import export_all_packed
from medtok_tpu_torch.models.deepseek_v2 import Experts, RMSNorm
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from tests.dsv2_tiny import text_config

KG_NODES = 300


def hf_state_dict(cfg, seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded state_dict under HF DeepSeek-V2's names (``model.``
    prefixed, per-expert projections, an ``lm_head`` the encoder ignores)."""
    g = torch.Generator().manual_seed(seed)
    E, H, I = cfg.hidden_size, cfg.num_heads, cfg.moe_intermediate_size
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    sd = {"model.embed_tokens.weight": (cfg.vocab_size, E), "model.norm.weight": (E,),
          "lm_head.weight": (cfg.vocab_size, E)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": (E,),
                   p + "post_attention_layernorm.weight": (E,),
                   p + "self_attn.q_proj.weight": (H * dq, E),
                   p + "self_attn.kv_a_proj_with_mqa.weight": (cfg.kv_lora_rank
                                                               + cfg.qk_rope_head_dim, E),
                   p + "self_attn.kv_a_layernorm.weight": (cfg.kv_lora_rank,),
                   p + "self_attn.kv_b_proj.weight": (H * (cfg.qk_nope_head_dim
                                                           + cfg.v_head_dim), cfg.kv_lora_rank),
                   p + "self_attn.o_proj.weight": (E, H * cfg.v_head_dim)})
        if i < cfg.first_k_dense_replace:
            mlps = [(p + "mlp.", cfg.intermediate_size)]
        else:
            sd[p + "mlp.gate.weight"] = (cfg.n_routed_experts, E)
            mlps = [(p + f"mlp.experts.{e}.", I) for e in range(cfg.n_routed_experts)]
            mlps.append((p + "mlp.shared_experts.", I * cfg.n_shared_experts))
        for q, width in mlps:
            sd.update({q + "gate_proj.weight": (width, E), q + "up_proj.weight": (width, E),
                       q + "down_proj.weight": (E, width)})
    return {k: torch.randn(s, generator=g) for k, s in sd.items()}


def test_hf_names_load_into_the_encoder():
    cfg = text_config()
    hf = hf_state_dict(cfg)
    model = MultimodalTokenizer(ModelConfig(text=cfg, compute_dtype="float32"))
    model.text_model.load_state_dict(convert_hf_deepseek_v2(hf, cfg), strict=True)
    own = model.text_model.state_dict()
    I = cfg.moe_intermediate_size
    for name, value in own.items():
        if ".mlp.experts." in name:
            layer = name.split(".")[1]
            for e in range(cfg.n_routed_experts):
                x = f"model.layers.{layer}.mlp.experts.{e}."
                if name.endswith("gate_up_proj"):
                    assert torch.equal(value[e, :I], hf[x + "gate_proj.weight"])
                    assert torch.equal(value[e, I:], hf[x + "up_proj.weight"])
                else:
                    assert torch.equal(value[e], hf[x + "down_proj.weight"])
        else:
            assert torch.equal(value, hf["model." + name]), name
    # numpy values and no prefix load the same
    plain = {k[len("model."):] if k.startswith("model.") else k: v.numpy()
             for k, v in hf.items()}
    again = convert_hf_deepseek_v2(plain, cfg)
    assert all(torch.equal(again[k], own[k]) for k in own)


def test_a_missing_expert_is_named():
    cfg = text_config()
    hf = hf_state_dict(cfg)
    del hf["model.layers.2.mlp.experts.5.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.2.mlp.experts.5.up_proj"):
        convert_hf_deepseek_v2(hf, cfg)


def _flax_tree(model: nn.Module) -> dict:
    """The model's parameters as the ``/``-keyed tree ``convert.load_params``
    reads: Dense ``kernel`` = weight.T, LayerNorm and RMSNorm ``scale``,
    Embed ``embedding``, the stacked experts as they are."""
    tree: dict = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            leaf, value = pname, p.detach().float().numpy()
            if pname == "weight" and isinstance(module, nn.Linear):
                leaf, value = "kernel", value.T
            elif pname == "weight" and isinstance(module, (nn.LayerNorm, RMSNorm)):
                leaf = "scale"
            elif pname == "weight" and isinstance(module, nn.Embedding):
                leaf = "embedding"
            else:
                assert pname == "bias" or isinstance(module, Experts) or pname == "codebook", \
                    (mname, pname)
            node = tree
            for part in mname.split(".") if mname else []:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(value)
    return tree


def test_export_cli_config_route(tmp_path):
    rng = np.random.default_rng(0)
    cols = synthetic_vocab_columns(rng, num_codes=20, num_kg_nodes=KG_NODES, max_pkg_nodes=10)
    src, dst = rng.integers(0, KG_NODES, (2, 3000))
    lines = ["x_index,y_index,display_relation,x_name"] + [
        f"{s},{d},ppi,\"n{s}, x\"" for s, d in zip(src, dst)]
    (tmp_path / "kg.csv").write_text("\n".join(lines) + "\n")
    write_jsonl(cols, tmp_path / "codes.jsonl")
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    (tmp_path / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    data = DataConfig(text_buckets=(8, 16, 32), node_buckets=(8, 16), edge_buckets=(16, 64),
                      max_text_length=32)
    cfg = MedTokConfig(model=dataclasses.replace(
        ModelConfig(text=text_config(), compute_dtype="float32", max_text_length=32),
        graph=dataclasses.replace(ModelConfig().graph, num_nodes=KG_NODES, in_channels=8,
                                  hidden_channels=16, out_channels=16),
        quantizer=dataclasses.replace(ModelConfig().quantizer, codebook_size=90,
                                      codebook_embed_dim=16, usage_buffer_size=4096)),
        data=data)
    cfg.save(tmp_path / "args.json")
    model = init_random_(MultimodalTokenizer(cfg.model), torch.Generator().manual_seed(2))
    save_npz(_flax_tree(model), tmp_path / "params.npz")
    got = export_cli.main(["--config", str(tmp_path / "args.json"), "--params",
                           str(tmp_path / "params.npz"), "--kg", str(tmp_path / "kg.csv"),
                           "--codes", str(tmp_path / "codes.jsonl"), "--vocab",
                           str(tmp_path / "vocab.txt"), "--device", "cpu",
                           "--out-dir", str(tmp_path / "out")])
    assert json.loads((tmp_path / "args.json").read_text())["model"]["text"][
        "architecture"] == "deepseek_v2"
    ds = MedCodeDataset.from_path(KnowledgeGraph.from_csv(str(tmp_path / "kg.csv")),
                                  str(tmp_path / "codes.jsonl"),
                                  WordPieceTokenizer.from_vocab_file(str(tmp_path / "vocab.txt")),
                                  cfg=data)
    want = export_all_packed(model.eval(), ds, device="cpu")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
