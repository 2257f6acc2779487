"""The DeepSeek-V2 text encoder (``models/deepseek_v2.py``) against the plain
reference (``portbench/reference/deepseek_v2.py``) on seeded weights at a
tiny size, in fp32 on the CPU: the encoder's states, a packed row of
several codes against each code alone, the grouped MoE against a per-token
loop, the last-token pooling, and the config's round trip.

Tolerances: both sides compute in fp32 and differ only in the order of
their sums (grouped products against a loop, SDPA against an explicit
softmax), a few ulps an operation; over three layers a token's state moves
by about 1e-6 of its norm, so 2e-5 leaves room for that and none for a
changed equation (a wrong expert, RoPE frequency, mask or scale moves
states by 1e-2 and more)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medtok_tpu_torch.config import (
    DeepseekV2TextConfig,
    MedTokConfig,
    ModelConfig,
    TextEncoderConfig,
)
from medtok_tpu_torch.models.deepseek_v2 import DeepseekV2Encoder, MoE, last_first
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from portbench.reference.deepseek_v2 import DeepseekV2, text_param_spec
from tests.dsv2_tiny import padded_ids, relative_rows, text_config, text_dict, weights

TOL = 2e-5


@pytest.fixture(scope="module")
def encoder():
    w = weights(text_param_spec(text_dict()), seed=3)
    enc = DeepseekV2Encoder(text_config(), dtype=torch.float32)
    enc.load_state_dict({k[len("text_model."):]: v for k, v in w.items()}, strict=True)
    return enc.eval(), DeepseekV2(text_dict(), w)


def test_encoder_states_match_the_reference(encoder):
    """Padded codes of 1-30 tokens (positions past the YaRN ramp's pairs
    turn): every real token's final state within TOL of the reference's."""
    enc, ref = encoder
    lens = [30, 17, 1, 9, 24, 2]
    ids, mask = padded_ids(1, lens, 32)
    with torch.no_grad():
        got = enc(ids, mask.int())
    want = ref.forward(ids, mask)
    err = relative_rows(got, want)[mask.numpy()]
    assert err.max() < TOL, err.max()


def test_packed_row_equals_each_code_alone(encoder):
    """Four codes packed into one 64-slot row (segment ids, positions from 0
    in each) give each code's states as run alone: attention is causal
    within a segment and positions restart."""
    enc, _ = encoder
    lens = [13, 7, 21, 11]
    ids, mask = padded_ids(2, lens, 21)
    row = torch.zeros(1, 64, dtype=torch.long)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    pos = torch.zeros(1, 64, dtype=torch.long)
    at = 0
    for c, n in enumerate(lens):
        row[0, at:at + n] = ids[c, :n]
        seg[0, at:at + n] = c + 1
        pos[0, at:at + n] = torch.arange(n)
        at += n
    with torch.no_grad():
        packed = enc(row, None, position_ids=pos, segments=seg)[0]
        alone = enc(ids, mask.int())
    at = 0
    for c, n in enumerate(lens):
        err = relative_rows(packed[at:at + n], alone[c, :n])
        assert err.max() < TOL, (c, err.max())
        at += n


def test_expert_load_counts_real_tokens_only(encoder):
    """Under a profiler each MoE layer's load counter takes k pairs a real
    token of a packed row, by the gate's own choice, and none of the
    padding slots; without one it takes nothing."""
    from medtok_tpu_torch.utils.profiling import read_device_counts

    enc, _ = encoder
    ids, _ = padded_ids(8, [40], 40)
    row = torch.zeros(1, 48, dtype=torch.long)
    row[0, :40] = ids[0]
    seg = (torch.arange(48) < 40).int()[None] + (torch.arange(48) >= 25).int()[None]
    seg[0, 40:] = 0
    pos = torch.where(torch.arange(48) < 25, torch.arange(48), torch.arange(48) - 25)[None]
    read_device_counts()
    with torch.no_grad():
        enc(row, None, position_ids=pos, segments=seg)
        assert read_device_counts() == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            enc(row, None, position_ids=pos, segments=seg)
    load = read_device_counts()
    k = enc.cfg.num_experts_per_tok
    assert sorted(load) == ["moe.expert_load.1", "moe.expert_load.2"]
    assert all(sum(v) == 40 * k for v in load.values()), load


def test_grouped_products_refuse_what_they_cannot_take():
    from medtok_tpu_torch.models.deepseek_v2 import grouped_mm

    offs = torch.tensor([2, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        grouped_mm(torch.randn(5, 6), torch.randn(2, 8, 6), offs)
    got = grouped_mm(torch.randn(5, 8), torch.randn(2, 4, 8), offs)
    assert got.shape == (5, 4)


def test_prefix_states_do_not_see_later_tokens(encoder):
    """Causal: a code's first tokens keep their states when tokens follow."""
    enc, _ = encoder
    ids, _ = padded_ids(4, [20], 20)
    with torch.no_grad():
        full = enc(ids, torch.ones_like(ids))
        head = enc(ids[:, :8], torch.ones_like(ids[:, :8]))
    assert relative_rows(full[0, :8], head[0]).max() < TOL


def test_grouped_moe_equals_a_per_token_loop(encoder):
    """The MoE layer's sort, grouped products and fp32 combine against each
    token's own top-k experts summed one by one, plus the shared experts."""
    enc, _ = encoder
    moe: MoE = enc.layers[1].mlp
    c = moe.cfg
    x = torch.randn(50, c.hidden_size, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = moe(x)
        scores = torch.softmax(x @ moe.gate.weight.T, dim=-1)
        want = torch.zeros_like(x)
        gu, down = moe.experts.gate_up_proj, moe.experts.down_proj
        I = c.moe_intermediate_size
        for t in range(x.shape[0]):
            top = torch.topk(scores[t], c.num_experts_per_tok)
            for w, e in zip(top.values, top.indices):
                h = F.silu(gu[e, :I] @ x[t]) * (gu[e, I:] @ x[t])
                want[t] += w * c.routed_scaling_factor * (down[e] @ h)
        want += moe.shared_experts(x)
    assert relative_rows(got, want).max() < TOL


def test_last_token_pooling():
    """The tokenizer's text rows put each code's last real token first, the
    others after it in order, padding where it was; a causal encoder's
    pooled row is its last token's state."""
    idx = torch.arange(12).view(2, 6) + 100
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    assert last_first(idx, mask).tolist() == [[103, 100, 101, 102, 104, 105],
                                              [111, 106, 107, 108, 109, 110]]
    cfg = ModelConfig(text=text_config(), compute_dtype="float32",
                      max_text_length=32)
    model = init_random_(MultimodalTokenizer(cfg), torch.Generator().manual_seed(0)).eval()
    ids, m = padded_ids(6, [5, 9, 2], 12)
    with torch.no_grad():
        states = model.text_model(ids, m.int())
        rows = model.text_states(ids, m.int())
    for b, n in enumerate([5, 9, 2]):
        assert torch.equal(rows[b, 0], states[b, n - 1])
        assert torch.equal(rows[b, 1:n], states[b, :n - 1])


def test_config_round_trips(tmp_path):
    """A DeepSeek-V2 text block saves and loads as its own class with every
    field; a BERT block carries no architecture key (the JAX package's
    args.json is unchanged); an unknown architecture is refused."""
    cfg = MedTokConfig(model=ModelConfig(text=text_config()))
    cfg.save(tmp_path / "args.json")
    back = MedTokConfig.load(tmp_path / "args.json")
    assert back == cfg and isinstance(back.model.text, DeepseekV2TextConfig)
    assert dataclasses.asdict(back.model.text)["rope_factor"] == 4.0
    assert "architecture" not in dataclasses.asdict(MedTokConfig())["model"]["text"]
    assert type(MedTokConfig.from_dict({"model": {"text": {"hidden_size": 8}}}).model.text) \
        is TextEncoderConfig
    with pytest.raises(ValueError, match="unknown text architecture"):
        MedTokConfig.from_dict({"model": {"text": {"architecture": "gpt9"}}})
    # the published defaults
    lite = DeepseekV2TextConfig()
    assert (lite.num_layers, lite.n_routed_experts, lite.num_experts_per_tok,
            lite.kv_lora_rank, lite.moe_intermediate_size) == (27, 64, 6, 512, 1408)


def test_text_dropout_is_refused():
    with pytest.raises(ValueError, match="text_dropout_in_train"):
        MultimodalTokenizer(ModelConfig(text=text_config(), text_dropout_in_train=True))


def test_yarn_frequencies_and_scale():
    """DeepSeek-V2-Lite's YaRN: pairs 0-10 at the base frequency, 23-31 at a
    40th of it, a linear ramp between; the softmax scale 0.114722."""
    from medtok_tpu_torch.models.deepseek_v2 import softmax_scale, yarn_inv_freq

    lite = DeepseekV2TextConfig()
    base = 1e4 ** (-np.arange(0, 64, 2) / 64)
    ratio = yarn_inv_freq(lite).double().numpy() / base
    np.testing.assert_allclose(ratio[:11], 1.0, rtol=1e-6)
    np.testing.assert_allclose(ratio[23:], 1 / 40, rtol=1e-6)
    ramp = (np.arange(11, 23) - 10) / 13
    np.testing.assert_allclose(ratio[11:23], ramp / 40 + (1 - ramp), rtol=1e-6)
    assert abs(softmax_scale(lite) - 0.114722) < 1e-6
