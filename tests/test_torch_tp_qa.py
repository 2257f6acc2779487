"""QA finetuning on a (dp, tp) mesh: four gloo ranks of the port on the CPU
against JAX ``QAFinetuner(mesh_dp, mesh_tp)`` on virtual CPU devices, at
``TINY_LLAMA`` in fp32 (H 4, KV 2), from one state with nonzero ``lora_b``
(the JAX finetuner's draw, bridged by ``convert.load_qa_params``), two
AdamW steps of four rows:

- (dp 2, tp 2): LoRA on q / v, each tp rank one key / value head;
- (dp 1, tp 4), the GQA case tp > KV: each key / value head held by the
  two ranks whose query heads read it, LoRA on q / k / v / o (the shared
  heads' ``lora_b`` gradients summed over their ranks, o's LoRA on the
  gathered heads).

JAX's own tolerances (``tests/test_qa.py``): the losses within 1e-4
relative, every trainable tensor gathered to the one-device layout within
rtol 1e-3 / atol 1e-6. The replicated tensors (``lora_a``, o's ``lora_b``,
the projector) bitwise equal on all four ranks; greedy ``generate`` tokens
equal to the one-device port's after the same steps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from medtok_tpu.qa import finetune as jft
from medtok_tpu.qa.llama import TINY_LLAMA as JTINY
from medtok_tpu.qa.sharding import shard_qa_params
from medtok_tpu_torch.convert import load_qa_params
from medtok_tpu_torch.qa import finetune
from medtok_tpu_torch.qa.llama import TINY_LLAMA, generate
from tests.test_torch_qa_finetune import VOCAB, _by_port_name, _rows
from tests.torch_dp_ranks import spawn_ranks

WORLD, NEW_TOKENS = 4, 6
CFG = dict(lora_rank=2, cutoff_len=8, total_len=24, batch_size=4, epochs=1)
QV, QKVO = ("q_proj", "v_proj"), ("q_proj", "k_proj", "v_proj", "o_proj")
MESHES = [((2, 2), dict(CFG)), ((1, 4), dict(CFG, lora_targets=QKVO))]


def _start(table, targets):
    """JAX's initial params for ``targets`` with every lora_b nonzero."""
    jf = jft.QAFinetuner(JTINY, table, jft.QAFinetuneConfig(**CFG, lora_targets=targets))
    params = jax.tree.map(np.asarray, jax.device_get(jf.init_params(None)))
    rng = np.random.default_rng(1)
    for i in range(JTINY.num_layers):
        for name in targets:
            node = params["llm"][f"layers_{i}"]["self_attn"][name]
            node["lora_b"] = (0.1 * rng.normal(size=node["lora_b"].shape)).astype(np.float32)
    return params


def _port(table, params, targets):
    pf = finetune.QAFinetuner(TINY_LLAMA, table,
                              finetune.QAFinetuneConfig(**CFG, lora_targets=targets),
                              device="cpu")
    load_qa_params(pf.model, pf.soft_prompt, params)
    return pf


@pytest.fixture(scope="module")
def tp_qa(tmp_path_factory):
    table = np.random.default_rng(0).normal(size=(VOCAB, 256)).astype(np.float32)
    rows = _rows(3, 8)
    starts = {t: _start(table, t) for t in (QV, QKVO)}
    llm, projector = {}, {}
    for t, params in starts.items():
        pf = _port(table, params, t)
        llm[t] = {k: v.clone() for k, v in pf.model.state_dict().items()}
        projector[t] = {k: v.clone() for k, v in pf.soft_prompt.projector.state_dict().items()}
    rng = np.random.default_rng(2)
    prompt = (rng.normal(size=(2, 5, TINY_LLAMA.hidden_size)).astype(np.float32),
              np.asarray([[1, 1, 1, 1, 1], [0, 0, 1, 1, 1]], np.int64))
    spec = dict(meshes=MESHES, table=table, rows=rows, llm=llm, projector=projector,
                prompt=prompt, new_tokens=NEW_TOKENS)
    ranks = spawn_ranks("tp_qa", WORLD, tmp_path_factory.mktemp("tp_qa"), spec)
    return table, rows, starts, prompt, ranks


def _jax_fit(table, rows, params, dp, tp, targets):
    jf = jft.QAFinetuner(JTINY, table, jft.QAFinetuneConfig(
        **CFG, lora_targets=targets, mesh_dp=dp, mesh_tp=tp))
    losses = []
    out = jf.fit(shard_qa_params(params, jf.mesh), rows,
                 log_fn=lambda s, loss: losses.append(loss))
    return losses, _by_port_name(jf.split_params(jax.device_get(out))[0])


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=["dp2-tp2", "dp1-tp4"])
def test_finetune_matches_the_jax_mesh(tp_qa, mesh):
    table, rows, starts, _, ranks = tp_qa
    targets = dict(MESHES)[mesh].get("lora_targets", QV)
    losses, want = _jax_fit(table, rows, starts[targets], *mesh, targets)
    assert len(losses) == 2
    for r in ranks:
        got = r[mesh]
        assert got["losses"] == pytest.approx(losses, rel=1e-4)
        assert set(got["trained"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got["trained"][name].numpy(), w, rtol=1e-3, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=["dp2-tp2", "dp1-tp4"])
def test_ranks_agree_and_generate_the_one_device_tokens(tp_qa, mesh):
    table, rows, starts, prompt, ranks = tp_qa
    targets = dict(MESHES)[mesh].get("lora_targets", QV)
    ref = ranks[0][mesh]
    assert {n.rsplit(".", 1)[-1] for n in ref["replicated"]} >= {"lora_a", "weight", "bias"}
    for r in ranks[1:]:
        got = r[mesh]
        assert got["losses"] == ref["losses"]
        for name, t in ref["replicated"].items():
            assert torch.equal(got["replicated"][name], t), name
    pf = _port(table, starts[targets], targets)
    pf.fit(rows)
    want = generate(pf.model, *(torch.from_numpy(a) for a in prompt),
                    max_new_tokens=NEW_TOKENS, temperature=0.0, device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r[mesh]["tokens"], want)


def test_the_port_refuses_a_gqa_split_it_cannot_hold():
    from medtok_tpu_torch.qa.sharding import check_divisibility

    cfg = dataclasses.replace(TINY_LLAMA, num_heads=6, num_kv_heads=3, hidden_size=96)
    with pytest.raises(ValueError, match="num_kv_heads 3 % tp == 0 or tp % 3 == 0"):
        check_divisibility(cfg, 2)
    check_divisibility(TINY_LLAMA, 4)
