"""The ``medtok-dsv2lite`` pieces of the benchmark on the CPU: its counts
against hand counts, its metric readers on a synthetic ``ctx``, and the
``export-dsv2lite`` cell end to end at a tiny size in fp32 against the port."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import counts, counts_dsv2, harness
from portbench.tests import tiny
from portbench.trace import Trace

LITE = harness.load_json(harness.ROOT / "configs" / "medtok-dsv2lite.json")


def test_the_configuration_is_the_published_one():
    """The file's top-level keys are DeepSeek-V2-Lite's config.json; the
    port's text block says the same."""
    t = LITE["model"]["text"]
    assert (LITE["num_hidden_layers"], LITE["hidden_size"], LITE["n_routed_experts"],
            LITE["num_experts_per_tok"], LITE["moe_intermediate_size"],
            LITE["kv_lora_rank"], LITE["vocab_size"]) == (27, 2048, 64, 6, 1408, 512, 102400)
    assert (t["num_layers"], t["hidden_size"], t["n_routed_experts"], t["num_experts_per_tok"],
            t["moe_intermediate_size"], t["kv_lora_rank"], t["vocab_size"],
            t["intermediate_size"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
            t["v_head_dim"], t["first_k_dense_replace"], t["n_shared_experts"]) == (
        LITE["num_hidden_layers"], LITE["hidden_size"], LITE["n_routed_experts"],
        LITE["num_experts_per_tok"], LITE["moe_intermediate_size"], LITE["kv_lora_rank"],
        LITE["vocab_size"], LITE["intermediate_size"], LITE["qk_nope_head_dim"],
        LITE["qk_rope_head_dim"], LITE["v_head_dim"], LITE["first_k_dense_replace"],
        LITE["n_shared_experts"])
    rs = LITE["rope_scaling"]
    assert (t["rope_factor"], t["rope_original_max_position"], t["rope_beta_fast"],
            t["rope_beta_slow"], t["rope_mscale"], t["rope_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
        rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    assert LITE["reduced"] == ["max_text_length"]


def test_counts_against_hand_counts():
    t = LITE["model"]["text"]
    # by hand: the MLA projections 2048x3072 + 2048x576 + 512x4096 + 2048x2048,
    # 27 layers; the dense SwiGLU 3 x 2048 x 10944; each MoE layer the gate
    # 2048 x 64 and 8 SwiGLUs of 3 x 2048 x 1408
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    hand = 2 * (27 * mla + 3 * 2048 * 10944 + 26 * (2048 * 64 + 8 * 3 * 2048 * 1408))
    assert counts_dsv2.encoder_flops_per_token(t) == hand
    assert 4.4e9 < hand < 4.6e9           # about 2.24B active parameters a token
    # causal attention: a 3-token code has 1 + 2 + 3 (query, key) pairs
    attn = 27 * 2 * 16 * (128 + 64 + 128) * 6
    assert counts_dsv2.encoder_flops(t, [3]) == 3 * hand + attn
    tail = dict(LITE["model"], text=dict(t, num_layers=0))
    args = ([3, 5], [4, 9], [2, 30])
    assert counts_dsv2.model_flops(LITE["model"], *args) == pytest.approx(
        counts_dsv2.encoder_flops(t, args[0]) + counts.model_flops(tail, *args, train=False))
    # experts: 29,000 real tokens a step are bound by their products; 10 by
    # the 1.107 GB of expert weights a layer
    ops = 2 * 3 * 2048 * 1408 * 29_000 * 6 / counts.PEAK_BF16
    assert counts_dsv2.experts_bound_s(t, [29_000]) == pytest.approx(26 * ops)
    weights = 64 * 3 * 2048 * 1408 * 2 / counts.PEAK_BYTES
    assert counts_dsv2.experts_bound_s(t, [10, 10]) == pytest.approx(2 * 26 * weights)


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_metric_readers_on_a_synthetic_ctx():
    tr = Trace(window_s=2.0, busy_s=1.9,
               range_device_s={"export.text": 0.9, "text.mla": 0.2, "text.moe.gate": 0.05,
                               "text.moe.dispatch": 0.05, "text.moe.experts": 0.4,
                               "text.moe.combine": 0.05, "text.moe.shared": 0.05})
    ctx = {"trace": tr, "steps": 10, "experts_bound_s": 0.3,
           "expert_load": {"moe.expert_load.1": [10, 10, 20, 0],
                           "moe.expert_load.2": [5, 5, 5, 5]}}
    assert reader("text_ms.export").read(ctx) == pytest.approx(90.0)
    assert reader("mla_ms.export").read(ctx) == pytest.approx(20.0)
    assert reader("moe_ms.export").read(ctx) == pytest.approx(60.0)
    assert reader("experts_roofline.export").read(ctx) == pytest.approx(75.0)
    assert reader("moe_imbalance.export").read(ctx) == pytest.approx((2.0 + 1.0) / 2)
    empty = {"trace": Trace(), "steps": 0, "expert_load": {}}
    for name in ("text_ms.export", "mla_ms.export", "moe_ms.export", "experts_roofline.export",
                 "moe_imbalance.export"):
        assert reader(name).read(empty) is None
        assert reader(name).read(dict(empty, trace=None)) is None


def tiny_config() -> dict:
    cfg = harness.load_json(harness.ROOT / "configs" / "medtok-dsv2lite.json")
    base = tiny.config()
    cfg["model"]["text"].update(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=96,
        kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2,
        num_experts_per_tok=3, rope_original_max_position=256, rope_factor=4.0)
    for k in ("graph", "quantizer", "compute_dtype"):
        cfg["model"][k] = base["model"][k]
    cfg["data"] = base["data"]
    return cfg


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_agrees_with_the_port_in_fp32(trace):
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    traffic = dict(tiny.traffic("export"), driver="export_dsv2")
    cell = harness.Cell("export-dsv2lite", bench, config=tiny_config(), traffic=traffic,
                        limits={})
    res = harness.run_cell(cell, seed=2**35 + 9, seconds=0.3, trace=bool(trace),
                           device="cpu", t0=time.perf_counter())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert set(checks) == {"token_gap", "weight_err", "embedding_err", "text_err"}
    assert checks["token_gap"] == 0.0
    assert max(checks.values()) < 1e-4, checks
    if trace:
        m = res["metrics"]
        # the CPU trace holds no device time: only the counters are read
        assert {"text_fill.export", "node_fill.export", "code_fill.export",
                "moe_imbalance.export"} <= set(m)
        assert 1.0 <= m["moe_imbalance.export"]["value"] <= 8.0
        assert not any(k.endswith(("_ms.export", "roofline.export")) for k in m)
    else:
        assert res["metrics"]["export_codes_per_s"]["value"] > 0


def test_pooling_at_the_first_token_fails_text_err(monkeypatch):
    """``text_err`` reads the window's own path: with the tail fed each
    code's first token in place of its last, it reads far above the fp32
    agreement the test above holds."""
    from medtok_tpu_torch.models import tokenizer_model

    monkeypatch.setattr(tokenizer_model, "last_first", lambda index, mask: index)
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    traffic = dict(tiny.traffic("export"), driver="export_dsv2")
    cell = harness.Cell("export-dsv2lite", bench, config=tiny_config(), traffic=traffic,
                        limits={})
    res = harness.run_cell(cell, seed=2**35 + 11, seconds=0.3, trace=False, device="cpu",
                           t0=time.perf_counter())
    assert res["checks"]["text_err"]["value"] > 0.1, res["checks"]


def test_parent_without_the_encoder_fails_at_once(monkeypatch):
    """A program without the DeepSeek-V2 config fails at the start of
    set-up, not after building the corpus."""
    import medtok_tpu_torch.config as config

    from portbench.drivers import export_dsv2

    monkeypatch.delattr(config, "DeepseekV2TextConfig")
    run = export_dsv2.Run(tiny_config(), tiny.traffic("export"), 1, "cpu")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        run.setup()
    assert time.perf_counter() - t0 < 5
    assert np.isfinite(t0)
