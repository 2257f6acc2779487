"""Port vs JAX: the QA finetuner at TINY_LLAMA with LoRA (nonzero lora_b),
the JAX finetuner's params tree bridged by ``convert.load_qa_params``: the
soft-prompt batch, the loss and the trainable gradients, three AdamW steps
against ``optax.adamw``, the frozen base, ``fit``'s batch order, and
``evaluate_qa``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.qa import finetune as jft
from medtok_tpu.qa import inference as jinf
from medtok_tpu.qa.llama import TINY_LLAMA as JTINY
from medtok_tpu.qa.softprompt import MedTokSoftPrompt as JSoftPrompt
from medtok_tpu_torch.convert import flatten_tree, load_qa_params
from medtok_tpu_torch.qa import finetune, inference
from medtok_tpu_torch.qa.llama import TINY_LLAMA
from medtok_tpu_torch.qa.prompting import pack_example
from medtok_tpu_torch.qa.softprompt import MedTokSoftPrompt

CL, TOTAL, VOCAB = 8, 24, 50
CFG = dict(lora_rank=2, cutoff_len=CL, total_len=TOTAL, batch_size=2, epochs=1)


def _rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        prompt = rng.integers(10, 512, rng.integers(2, 8)).tolist()
        codes = rng.integers(0, VOCAB + 20, rng.integers(0, 5)).tolist()   # some past the table
        rows.append(pack_example(prompt, [int(rng.integers(10, 512))], codes, cutoff_len=CL,
                                 eos_token_id=3))
    return rows


@pytest.fixture(scope="module")
def pair():
    """(JAX finetuner, its params with nonzero lora_b, the port's finetuner
    holding the same weights)."""
    table = np.random.default_rng(0).normal(size=(VOCAB, 256)).astype(np.float32)
    jf = jft.QAFinetuner(JTINY, table, jft.QAFinetuneConfig(**CFG))
    params = jax.tree.map(np.asarray, jax.device_get(jf.init_params(None)))
    rng = np.random.default_rng(1)
    for i in range(JTINY.num_layers):
        for name in ("q_proj", "v_proj"):
            node = params["llm"][f"layers_{i}"]["self_attn"][name]
            node["lora_b"] = (0.1 * rng.normal(size=node["lora_b"].shape)).astype(np.float32)
    pf = finetune.QAFinetuner(TINY_LLAMA, table, finetune.QAFinetuneConfig(**CFG), device="cpu")
    load_qa_params(pf.model, pf.soft_prompt, params)
    return jf, params, pf


def _jax_packed(table, params, ids, mask, labels, embed, H=16):
    sp = JSoftPrompt(embeddings=table, hidden_size=H, cutoff_len=CL)
    return sp.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                    None if labels is None else jnp.asarray(labels),
                    lambda i: jnp.asarray(embed)[i], TOTAL)


@pytest.mark.parametrize("layout", ["right-padded", "left-padded", "unpadded"])
def test_soft_prompt_batch_matches_jax(layout):
    rng = np.random.default_rng(4)
    B, Lt, H = 3, 6, 16
    table = rng.normal(size=(VOCAB, 256)).astype(np.float32)
    embed = rng.normal(size=(100, H)).astype(np.float32)
    ids = np.zeros((B, CL + Lt), np.int64)
    mask = np.zeros((B, CL + Lt), np.int64)
    labels = np.full((B, Lt), -100, np.int64)
    for i in range(B):
        n_med = [0, 3, CL][i]   # no codes, some, all slots
        ids[i, :n_med] = rng.integers(0, VOCAB + 10, n_med)
        mask[i, :n_med] = 1
        n = Lt if layout == "unpadded" else int(rng.integers(1, Lt))
        cols = slice(CL + Lt - n, CL + Lt) if layout == "left-padded" else slice(CL, CL + n)
        ids[i, cols] = rng.integers(1, 100, n)
        mask[i, cols] = 1
        lab = slice(Lt - n, Lt) if layout == "left-padded" else slice(0, n)
        labels[i, lab] = rng.integers(1, 100, n)
    params = {"projector": {"kernel": rng.normal(size=(256, H)).astype(np.float32) / 16,
                            "bias": rng.normal(size=(H,)).astype(np.float32)}}
    sp = MedTokSoftPrompt(table, H, CL, device="cpu")
    sp.projector.weight.data = torch.as_tensor(params["projector"]["kernel"].T.copy())
    sp.projector.bias.data = torch.as_tensor(params["projector"]["bias"])
    for lab in (labels, None):
        want = _jax_packed(table, params, ids, mask, lab, embed)
        with torch.no_grad():
            got = sp(torch.as_tensor(ids), torch.as_tensor(mask),
                     None if lab is None else torch.as_tensor(lab),
                     lambda i: torch.as_tensor(embed)[i], TOTAL)
        np.testing.assert_array_equal(got.attention_mask.numpy(), np.asarray(want.attention_mask))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        prefix = np.zeros((B, TOTAL), bool)
        prefix[np.arange(B), TOTAL - mask[:, CL:].sum(1) - 1] = True
        emb, wemb = got.inputs_embeds.numpy(), np.asarray(want.inputs_embeds)
        np.testing.assert_array_equal(emb[~prefix], wemb[~prefix])   # text and filler
        np.testing.assert_allclose(emb[prefix], wemb[prefix], rtol=1e-6, atol=1e-6)


def _by_port_name(tree) -> dict:
    """A JAX {"llm", "soft_prompt"} tree (None holes dropped) keyed by the
    port's parameter names, the projector kernel transposed to a weight."""
    out = {}
    for key, v in flatten_tree(jax.tree.map(np.asarray, tree)).items():
        if v.dtype == object:
            continue
        name = key.replace("/", ".")
        if name.endswith("projector.kernel"):
            name, v = name.replace("kernel", "weight"), v.T
        out[name] = v
    return out


def test_loss_and_gradients_match_jax(pair):
    jf, params, pf = pair
    batch = finetune._collate_rows(_rows(5, 3), cutoff_len=CL)
    train, frozen = jf.split_params(params)
    jloss, jgrads = jax.value_and_grad(
        lambda tp: jf.loss_fn(jft.combine_params(tp, frozen), batch))(train)
    loss = pf.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _by_port_name(jgrads)
    got = {n: p.grad for n, p in pf.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    assert all(p.grad is None for _, p in pf.named_parameters() if not p.requires_grad)
    pf.optimizer.zero_grad(set_to_none=True)


def test_three_adamw_steps_match_optax_and_freeze_the_base(pair):
    jf, params, pf = pair
    before = {n: p.detach().clone() for n, p in pf.named_parameters()}
    pf.optimizer = pf.make_optimizer()
    train, frozen = jf.split_params(params)
    opt_state = jf.tx.init(train)
    for seed in (6, 7, 8):
        batch = finetune._collate_rows(_rows(seed, 2), cutoff_len=CL)
        train, opt_state, jloss = jf._step(train, frozen, opt_state, batch)
        loss = pf.train_step(batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _by_port_name(train)
    for name, p in pf.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-5,
                                       err_msg=name)
            assert not torch.equal(p, before[name]), name
        else:
            assert p.grad is None and torch.equal(p, before[name]), name
    # optimizer state only for the trainable tensors
    trainable = {id(p) for p in pf.trainable_parameters()}
    assert {id(p) for g in pf.optimizer.param_groups for p in g["params"]} == trainable
    assert {id(p) for p in pf.optimizer.state} == trainable


def test_trainable_set_and_optimizer_defaults(pair):
    _, _, pf = pair
    names = [n for n, p in pf.named_parameters() if p.requires_grad]
    assert sorted(names) == sorted(
        [f"llm.layers_{i}.self_attn.{m}.{ab}" for i in range(2) for m in ("q_proj", "v_proj")
         for ab in ("lora_a", "lora_b")] + ["soft_prompt.projector.weight",
                                           "soft_prompt.projector.bias"])
    group = pf.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4 and group["lr"] == 3e-4
    # a mesh without a process group of its size names the launch it needs
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        finetune.QAFinetuner(TINY_LLAMA, np.zeros((4, 256), np.float32),
                             finetune.QAFinetuneConfig(mesh_tp=2), device="cpu")


def test_fit_takes_jax_batch_order_and_drops_the_partial_batch(pair, monkeypatch):
    jf, _, _ = pair
    rows = _rows(9, 7)
    cfg = finetune.QAFinetuneConfig(**{**CFG, "epochs": 2, "seed": 3})
    jf2 = jft.QAFinetuner(JTINY, np.zeros((VOCAB, 256), np.float32),
                          jft.QAFinetuneConfig(**dataclasses.asdict(cfg)))
    jseen, seen = [], []

    def jstep(train_p, frozen_p, opt_state, batch):
        jseen.append(batch)
        return train_p, opt_state, jnp.float32(0.0)

    jf2._step = jstep
    jf2.fit(jf2.init_params(None), rows)
    pf = finetune.QAFinetuner(TINY_LLAMA, np.zeros((VOCAB, 256), np.float32), cfg, device="cpu")
    monkeypatch.setattr(pf, "train_step", lambda b: seen.append(b) or torch.tensor(0.0))
    steps = []
    pf.fit(rows, log_fn=lambda s, loss: steps.append(s))
    assert len(seen) == len(jseen) == 6 and steps == list(range(1, 7))
    for a, b in zip(seen, jseen):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_init_params_lays_loaded_weights_over_a_fresh_init():
    table = np.zeros((VOCAB, 256), np.float32)
    pf = finetune.QAFinetuner(TINY_LLAMA, table, finetune.QAFinetuneConfig(**CFG), device="cpu")
    base = {k: torch.full_like(v, 0.5) for k, v in pf.model.state_dict().items()
            if "lora" not in k}
    pf.init_params(base)
    sd = pf.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in base.items())
    assert sd["layers_0.self_attn.q_proj.lora_b"].abs().max() == 0
    assert 0 < sd["layers_0.self_attn.q_proj.lora_a"].std() < 0.05
    with pytest.raises(KeyError, match="no LlamaModel parameter"):
        pf.init_params({"nope.weight": torch.zeros(1)})


def test_evaluate_qa_matches_jax(pair):
    """Greedy evaluation of prompt-only rows (no eos, 3 new tokens) gives
    JAX's predictions, decoded from the same token ids."""
    jf, params, pf = pair
    table = jinf.extend_with_miss_rows(np.zeros((VOCAB - 5, 256), np.float32), num_miss_rows=5)
    np.testing.assert_array_equal(
        table, inference.extend_with_miss_rows(np.zeros((VOCAB - 5, 256), np.float32),
                                               num_miss_rows=5))
    rows = [pack_example(r["input_ids"][CL:], [], r["input_ids"][:2], cutoff_len=CL)
            for r in _rows(10, 5)]
    labels = ["A", "B", "C", "D", "A"]
    letters = {i: "ABCD"[i % 4] for i in range(512)}

    def decode(ids):
        return "Answer: " + letters[int(ids[0])]

    kw = dict(max_new_tokens=3, temperature=0.0, batch_size=2)
    jacc, jpreds = jinf.evaluate_qa(jf, params, rows, labels, decode, **kw)
    acc, preds = inference.evaluate_qa(pf, rows, labels, decode, **kw)
    assert preds == jpreds and acc == jacc
