"""Tokenizer training, the port against the JAX trainer at fp32 on the CPU:
``_loss_fn`` (all 22 metrics, every trainable parameter's gradient, the
usage FIFO) on the packed and the unpacked text route, and three clipped
Adam steps with the parameter EMA through ``make_train_step``.

Both sides start from one state: the JAX ``create_train_state`` output
bridged by ``convert.load_params`` (params and the usage collection) into
the port's fp32-parameter model. The cross-attention dropout is 0 here:
flax's dropout bits and torch's differ by design.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import GraphEncoderConfig as JaxGraphConfig
from medtok_tpu.config import MedTokConfig as JaxMedTokConfig
from medtok_tpu.config import ModelConfig as JaxModelConfig
from medtok_tpu.config import QuantizerConfig as JaxQuantizerConfig
from medtok_tpu.config import TextEncoderConfig as JaxTextConfig
from medtok_tpu.config import TrainConfig as JaxTrainConfig
from medtok_tpu.data.packing import pack_code_batch as jax_pack_code_batch
from medtok_tpu.data.synthetic import random_code_batch
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.parallel.mesh import make_mesh
from medtok_tpu.train.trainer import _loss_fn as jax_loss_fn
from medtok_tpu.train.trainer import create_train_state as jax_create_train_state
from medtok_tpu.train.trainer import make_train_step as jax_make_train_step
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.data.types import CodeBatch, PackedTextBatch
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.train.trainer import (
    _loss_fn,
    create_train_state,
    make_train_step,
    trainable_parameters,
)

B, TEXT_LEN, ROW_LEN, ROWS = 8, 16, 64, 4
# the key projection's bias has an exact gradient of 0 (a softmax row does
# not change when one constant is added to all its logits): both sides hold
# rounding noise there, bounded against the key weight's gradient
ZERO_GRAD = "multihead_attn.k_proj.bias"


def jax_config(dtype: str = "float32", **train) -> JaxMedTokConfig:
    """The tiny config: text 2 layers of 32 wide with 4 heads, graph
    8 / 16 / 16, codebook 90 x 16, batch 8, cross-attention dropout 0."""
    model = JaxModelConfig(
        text=JaxTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                           intermediate_size=64, max_position_embeddings=64),
        graph=JaxGraphConfig(num_nodes=500, in_channels=8, hidden_channels=16,
                             out_channels=16),
        quantizer=JaxQuantizerConfig(codebook_size=90, codebook_embed_dim=16,
                                     usage_buffer_size=4096, cross_attn_dropout=0.0),
        max_text_length=TEXT_LEN, compute_dtype=dtype,
    )
    return JaxMedTokConfig(model=model, train=JaxTrainConfig(global_batch_size=B, **train))


def port_config(jcfg: JaxMedTokConfig) -> MedTokConfig:
    return MedTokConfig.from_dict(dataclasses.asdict(jcfg))


def host_batch(seed: int = 0):
    """A numpy CodeBatch with an edge-dropped copy, and its packed texts."""
    b = random_code_batch(np.random.default_rng(seed), batch=B, text_len=TEXT_LEN,
                          max_nodes=8, max_edges_per_graph=8, text_vocab=1000,
                          num_kg_nodes=500)
    packed = jax_pack_code_batch(np.asarray(b.input_ids), np.asarray(b.attention_mask),
                                 shards=1, rows_per_shard=ROWS, row_len=ROW_LEN)
    return b, packed


def jax_state(jcfg, jmodel, batch):
    """JAX ``create_train_state`` under jit (its eager init takes ~30 s)."""
    return jax.jit(lambda b: jax_create_train_state(jcfg, jmodel, b))(
        jax.tree.map(jnp.asarray, batch))


def variables_of(state) -> dict:
    """The flax variables (params + usage) of a JAX state, as numpy."""
    return {"params": jax.tree.map(np.asarray, state.params),
            "usage": jax.tree.map(np.asarray, state.usage)}


def port_state(cfg, jstate):
    model = MultimodalTokenizer(cfg.model, param_dtype=torch.float32)
    return create_train_state(cfg, model, params=variables_of(jstate))


def port_inputs(batch, packed, route: str):
    return CodeBatch(*batch).to("cpu"), (
        PackedTextBatch(*packed).to("cpu") if route == "packed" else None)


def assert_grads_match(model, jgrads, tol: float, zero_tol: float) -> None:
    """Every trainable parameter's gradient within ``tol`` of that
    gradient's largest element (the zero-gradient key bias within
    ``zero_tol`` of its layer's key-weight gradient); the text encoder gets
    none."""
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    trainable = dict(trainable_parameters(model))
    for name, p in model.named_parameters():
        if name.startswith("text_model."):
            assert not p.requires_grad and p.grad is None, name
            continue
        assert name in trainable and p.grad is not None, name
        got, w = p.grad.float().numpy(), want[name].numpy()
        if name.endswith(ZERO_GRAD):
            scale = np.abs(want[name.replace("bias", "weight")].numpy()).max()
            assert np.abs(got).max() <= zero_tol * scale, name
            assert np.abs(w).max() <= zero_tol * scale, name
            continue
        err = np.abs(got - w).max() / np.abs(w).max()
        assert err <= tol, (name, err)


@pytest.fixture(scope="module")
def fp32_setup():
    jcfg = jax_config()
    jmodel = JaxTokenizer(jcfg.model)
    batch, packed = host_batch()
    return jcfg, jmodel, batch, packed, jax_state(jcfg, jmodel, batch)


@pytest.mark.parametrize("route,entropy", [("unpacked", 0.0), ("packed", 0.0),
                                           ("unpacked", 0.5)])
def test_loss_fn_matches_jax_fp32(fp32_setup, route, entropy):
    """entropy > 0 adds the codebook-entropy term, fed by the quantizer's
    shared affinity."""
    jcfg, jmodel, batch, packed, jstate = fp32_setup
    if entropy:
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, quantizer=dataclasses.replace(
                jcfg.model.quantizer, entropy_loss_ratio=entropy)))
        jmodel = JaxTokenizer(jcfg.model)
    jpacked = jax.tree.map(jnp.asarray, packed) if route == "packed" else None
    grad_fn = jax.jit(lambda p, u, b, pk: jax.value_and_grad(jax_loss_fn, has_aux=True)(
        p, u, jmodel, b, jax.random.PRNGKey(3), jcfg, pk))
    (_, (want, want_usage)), jgrads = grad_fn(
        jstate.params, jstate.usage, jax.tree.map(jnp.asarray, batch), jpacked)

    cfg = port_config(jcfg)
    state = port_state(cfg, jstate)
    model = state.model.train()
    tbatch, tpacked = port_inputs(batch, packed, route)
    loss, got = _loss_fn(model, tbatch, cfg, packed=tpacked)
    loss.backward()
    assert set(got) == set(want) and len(got) == 22
    assert (float(got["entropy_loss"]) != 0.0) == bool(entropy)
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5, abs=1e-7), k
    assert_grads_match(model, jgrads, tol=1e-4, zero_tol=1e-6)
    # the usage FIFO took the same ids in the same order
    q = model.quantize
    np.testing.assert_array_equal(q.codebook_used.numpy(),
                                  np.asarray(want_usage["quantize"]["codebook_used"]))
    np.testing.assert_array_equal(q.usage_counts.numpy(),
                                  np.asarray(want_usage["quantize"]["usage_counts"]))


def test_three_train_steps_match_jax():
    """Three packed steps with the clip firing (max_grad_norm 0.5 against
    norms of about 30) and the EMA on: parameters, EMA parameters and the
    usage FIFO against JAX ``make_train_step`` on a 1-device mesh.

    Adam's first steps move each element by about lr * sign(g), so an
    element whose gradient is rounding noise on both sides may step either
    way. Elements whose JAX gradient stays below 1e-6 of its tensor's
    largest, and above 0, in every step are set aside (their count is asserted; for the
    key bias, whose exact gradient is 0, the key weight's largest); every
    other element is held within 1e-5 of its tensor's largest value."""
    jcfg = jax_config(lr=1e-3, max_grad_norm=0.5, ema=True, ema_decay=0.9,
                      packed_text=True)
    jmodel = JaxTokenizer(jcfg.model)
    batches = [host_batch(seed) for seed in (0, 1, 2)]
    jstate = jax_state(jcfg, jmodel, batches[0][0])
    cfg = port_config(jcfg)
    state = port_state(cfg, jstate)
    model = state.model
    step = make_train_step(cfg, model)

    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jstep = jax_make_train_step(jcfg, jmodel, mesh, donate=False, packed=True)
    grad_fn = jax.jit(lambda p, u, b, pk: jax.grad(
        lambda p_: jax_loss_fn(p_, u, jmodel, b, jax.random.PRNGKey(0), jcfg, pk)[0])(p))
    noise = {}
    for batch, packed in batches:
        jb, jp = jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray, packed)
        g = flax_params_to_state_dict(jax.tree.map(
            np.asarray, grad_fn(jstate.params, jstate.usage, jb, jp)))
        for name, v in g.items():
            # the zero-gradient key bias is measured against its layer's
            # key-weight gradient
            ref = g[name.replace("bias", "weight")] if name.endswith(ZERO_GRAD) else v
            a = np.abs(v.numpy())
            small = (a < 1e-6 * np.abs(ref.numpy()).max()) & (a > 0)
            noise[name] = small & noise.get(name, True)
        jstate, jmetrics = jstep(jstate, jb, jp)
        state, metrics = step(state, *port_inputs(batch, packed, "packed"))
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert state.step == int(jstate.step) == 3 and state.opt_state.count == 3

    params = flax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    emas = flax_params_to_state_dict(jax.tree.map(np.asarray, jstate.ema_params))
    set_aside = 0
    for (name, p), ema in zip(trainable_parameters(model), state.ema_params):
        keep = ~noise[name]
        set_aside += int((~keep).sum())
        for got, want in ((p.detach(), params[name]), (ema, emas[name])):
            got, want = got.numpy(), want.numpy()
            err = np.abs(got - want)[keep].max(initial=0.0) / np.abs(want).max()
            assert err <= 1e-5, (name, err)
    # what was set aside is the two key biases (2 layers x 16), no more
    assert set_aside == 2 * 16, set_aside
    # the frozen BERT is bit for bit where it started, and its EMA (JAX
    # keeps one for every parameter) within 1e-6 of it
    for name, p in model.named_parameters():
        if name.startswith("text_model."):
            np.testing.assert_array_equal(p.detach().numpy(), params[name].numpy())
            np.testing.assert_allclose(emas[name].numpy(), p.detach().numpy(),
                                       atol=1e-6, rtol=0)
    q = model.quantize
    np.testing.assert_array_equal(q.codebook_used.numpy(),
                                  np.asarray(jstate.usage["quantize"]["codebook_used"]))
    np.testing.assert_array_equal(q.usage_counts.numpy(),
                                  np.asarray(jstate.usage["quantize"]["usage_counts"]))
