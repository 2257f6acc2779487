"""The training variants, the port against the JAX trainer at fp32 on the
CPU: the GAT encoder, the EMA (``--kmeans``) codebook and its revival, and
BERT dropout (``text_dropout_in_train``).

- ``_loss_fn`` (all 22 metrics, every trainable parameter's gradient, the
  usage collection with the EMA codebook) and three clipped Adam steps
  through ``make_train_step`` against JAX ``make_train_step`` for GAT, for
  kmeans and for kmeans + revival, from one state (the JAX state bridged
  by ``convert.load_params``; in the kmeans modes its EMA codebook set to
  random unit rows, and with revival all but REVIVED of its rows given
  the assignment share 1 / C of an evenly used codebook, the REVIVED ones
  0); cross-attention dropout 0 and the set-aside rule of
  ``tests/test_torch_train_step.py`` for rounding-noise gradients. A loss
  term is held within rel 1e-5 or 2e-6 absolute: an InfoNCE term is the
  difference of two values of about 1 / 0.07 = 14, whose fp32 ulp is
  about 1e-6, and the GAT's exp rounds apart from XLA's;
- from the state JAX's ``kmeans_init_codebook`` leaves (drawn with
  replacement, it holds rows equal but for the last bit: a re-normalised
  cluster mean beside an empty cluster's copy of the same sample), the
  token rows agree with JAX's up to such ties (the export's tie-gap rule,
  gap below 1e-5); which of two such rows a sweep picks turns on
  rounding, so the steps above start from rows without near ties. So
  does revival: a row revived twice toward one feature sits within about
  1e-6 of every other row revived twice toward it, which is why only a
  few rows start dead above (each revived once, toward its own feature);
- BERT dropout: at rate 0 the variant equals JAX's training forward; at
  0.3 the keep rate and the 1 / (1 - p) scale; one generator state gives
  one mask and the two views differ; packed text with dropout raises; the
  Trainer takes a step with it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tie_gaps
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.parallel.mesh import make_mesh
from medtok_tpu.train.trainer import _loss_fn as jax_loss_fn
from medtok_tpu.train.trainer import kmeans_init_codebook as jax_kmeans_init_codebook
from medtok_tpu.train.trainer import make_train_step as jax_make_train_step
from medtok_tpu_torch.config import TextEncoderConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.data.types import CodeBatch, PackedTextBatch
from medtok_tpu_torch.models.bert import BertEncoder
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.train.trainer import _loss_fn, make_train_step, trainable_parameters
from tests.test_torch_train_step import (
    ZERO_GRAD,
    assert_grads_match,
    host_batch,
    jax_config,
    jax_state,
    port_config,
    port_inputs,
    port_state,
)

VARIANTS = {
    "gat": dict(graph=dict(model_name="GAT", gat_num_heads=4)),
    "kmeans": dict(quantizer=dict(use_kmeans=True)),
    "kmeans-revival": dict(quantizer=dict(use_kmeans=True, codebook_revival=True)),
}
EMA_KEYS = ("ema_codebook", "ema_cluster", "ema_embed_prob")
# the rows the revival steps start dead (assignment share 0)
REVIVED = (3, 17, 40, 71, 88)


def variant_config(name: str, **train):
    """The tiny config of tests/test_torch_train_step.py with the variant's
    fields."""
    jcfg = jax_config(**train)
    m = jcfg.model
    parts = {k: dataclasses.replace(getattr(m, k), **v) for k, v in VARIANTS[name].items()}
    return dataclasses.replace(jcfg, model=dataclasses.replace(m, **parts))


def variant_state(jcfg, jmodel, batch):
    """JAX's state; in the kmeans modes its EMA codebook set to random unit
    rows (no two rows near a tie), with revival the REVIVED rows dead and
    the others at the share 1 / C."""
    jstate = jax_state(jcfg, jmodel, batch)
    if not jcfg.model.quantizer.use_kmeans:
        return jstate
    usage = dict(jstate.usage)
    q = dict(usage["quantize"])
    x = np.random.default_rng(7).normal(size=q["ema_codebook"].shape).astype(np.float32)
    q["ema_codebook"] = jnp.asarray(x / np.linalg.norm(x, axis=-1, keepdims=True))
    if "ema_embed_prob" in q:
        C = x.shape[0]
        q["ema_embed_prob"] = jnp.full((C,), 1.0 / C, jnp.float32).at[
            np.array(REVIVED)].set(0.0)
    usage["quantize"] = q
    return jstate.replace(usage=usage)


def assert_usage_matches(model, usage) -> None:
    """The FIFO bit for bit, the EMA buffers within 1e-5 of their largest."""
    q, want = model.quantize, usage["quantize"]
    for k in ("codebook_used", "usage_counts"):
        np.testing.assert_array_equal(getattr(q, k).numpy(), np.asarray(want[k]))
    for k in EMA_KEYS:
        assert hasattr(q, k) == (k in want), k
        if k in want:
            w = np.asarray(want[k])
            err = np.abs(getattr(q, k).numpy() - w).max() / np.abs(w).max()
            assert err <= 1e-5, (k, err)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    jcfg = variant_config(request.param)
    jmodel = JaxTokenizer(jcfg.model)
    batch, packed = host_batch()
    return request.param, jcfg, jmodel, batch, packed, variant_state(jcfg, jmodel, batch)


def test_loss_fn_matches_jax(variant):
    name, jcfg, jmodel, batch, packed, jstate = variant
    grad_fn = jax.jit(lambda p, u, b, pk: jax.value_and_grad(jax_loss_fn, has_aux=True)(
        p, u, jmodel, b, jax.random.PRNGKey(3), jcfg, pk))
    (_, (want, want_usage)), jgrads = grad_fn(
        jstate.params, jstate.usage, jax.tree.map(jnp.asarray, batch),
        jax.tree.map(jnp.asarray, packed))

    cfg = port_config(jcfg)
    state = port_state(cfg, jstate)
    model = state.model.train()
    names = [n for n, _ in trainable_parameters(model)]
    assert ("quantize.codebook" in names) == (name == "gat")
    assert any("att_src" in n for n in names) == (name == "gat")
    tbatch, tpacked = port_inputs(batch, packed, "packed")
    loss, got = _loss_fn(model, tbatch, cfg, packed=tpacked)
    loss.backward()
    assert set(got) == set(want) and len(got) == 22
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5, abs=2e-6), k
    # conv2.att_dst's JAX gradient is exactly 0 when the scores of each
    # node's incoming edges fall on one side of the leaky relu (the shift
    # cancels in the softmax, and through the segment max in the gradient)
    assert_grads_match(model, jgrads, tol=1e-4, zero_tol=1e-6)
    assert_usage_matches(model, want_usage)


def test_kmeans_init_state_agrees_up_to_ties():
    """From the codebook JAX's kmeans_init_codebook leaves (near-duplicate
    rows), the four token rows of the training forward against JAX's by
    the tie-gap rule; the rows that agree carry the same weights."""
    jcfg = variant_config("kmeans")
    jmodel = JaxTokenizer(jcfg.model)
    batch, packed = host_batch()
    jstate = jax_kmeans_init_codebook(jmodel, jax_state(jcfg, jmodel, batch),
                                      [jax.tree.map(jnp.asarray, batch)])
    cb = np.asarray(jstate.usage["quantize"]["ema_codebook"])
    gaps = np.abs(cb[:, None] - cb[None]).max(-1)[np.triu_indices(len(cb), 1)]
    assert ((gaps > 0) & (gaps < 1e-6)).any()          # the near-duplicate rows
    out, _ = jmodel.apply({"params": jstate.params, "usage": jstate.usage},
                          jax.tree.map(jnp.asarray, batch), train=True,
                          packed=jax.tree.map(jnp.asarray, packed),
                          rngs={"dropout": jax.random.PRNGKey(3)}, mutable=["usage"])
    cfg = port_config(jcfg)
    model = port_state(cfg, jstate).model.train()
    tbatch, tpacked = port_inputs(batch, packed, "packed")
    with torch.no_grad():
        got = model.forward_train(tbatch, packed=tpacked)
    paths = ("text", "graph", "shared_text", "shared_graph")
    tok = np.stack([got[f"{p}_tokens"].numpy() for p in paths], 1)
    w = np.stack([got[f"{p}_tokens_weights"].numpy() for p in paths], 1)
    ref_tok = np.stack([np.asarray(out[f"{p}_tokens"]) for p in paths], 1)
    ref_w = np.stack([np.asarray(out[f"{p}_tokens_weights"]) for p in paths], 1)
    assert tie_gaps(tok, w, ref_tok, ref_w).max(initial=0.0) <= 1e-5
    same = (tok == ref_tok).all(-1)
    np.testing.assert_allclose(w[same], ref_w[same], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_three_train_steps_match_jax(name):
    """Three packed steps, the clip firing and the EMA on, as in
    tests/test_torch_train_step.py: parameters, EMA parameters and the
    usage collection (the EMA codebook too) against JAX make_train_step."""
    jcfg = variant_config(name, lr=1e-3, max_grad_norm=0.5, ema=True, ema_decay=0.9,
                          packed_text=True)
    jmodel = JaxTokenizer(jcfg.model)
    batches = [host_batch(seed) for seed in (0, 1, 2)]
    jstate = variant_state(jcfg, jmodel, batches[0][0])
    cfg = port_config(jcfg)
    state = port_state(cfg, jstate)
    model = state.model
    step = make_train_step(cfg, model)
    start = model.quantize.ema_codebook.clone() if hasattr(model.quantize, "ema_codebook") \
        else None

    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jstep = jax_make_train_step(jcfg, jmodel, mesh, donate=False, packed=True)
    grad_fn = jax.jit(lambda p, u, b, pk: jax.grad(
        lambda p_: jax_loss_fn(p_, u, jmodel, b, jax.random.PRNGKey(0), jcfg, pk)[0])(p))
    noise = {}
    for batch, packed in batches:
        jb, jp = jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray, packed)
        g = flax_params_to_state_dict(jax.tree.map(
            np.asarray, grad_fn(jstate.params, jstate.usage, jb, jp)))
        for pname, v in g.items():
            ref = g[pname.replace("bias", "weight")] if pname.endswith(ZERO_GRAD) else v
            a = np.abs(v.numpy())
            small = (a < 1e-6 * np.abs(ref.numpy()).max()) & (a > 0)
            noise[pname] = small & noise.get(pname, True)
        jstate, jmetrics = jstep(jstate, jb, jp)
        state, metrics = step(state, *port_inputs(batch, packed, "packed"))
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert state.step == int(jstate.step) == 3

    params = flax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    emas = flax_params_to_state_dict(jax.tree.map(np.asarray, jstate.ema_params))
    set_aside = {}
    for (pname, p), ema in zip(trainable_parameters(model), state.ema_params):
        keep = ~noise[pname]
        if (~keep).any():
            set_aside[pname] = int((~keep).sum())
        for got, want in ((p.detach(), params[pname]), (ema, emas[pname])):
            got, want = got.numpy(), want.numpy()
            err = np.abs(got - want)[keep].max(initial=0.0) / np.abs(want).max()
            assert err <= 1e-5, (pname, err)
    # what was set aside is the two key biases (2 layers x 16), no more
    assert all(n.endswith(ZERO_GRAD) for n in set_aside), set_aside
    assert sum(set_aside.values()) == 2 * 16, set_aside
    assert_usage_matches(model, jstate.usage)
    if jcfg.model.quantizer.codebook_revival:
        # revival rewrote dead rows toward a feature (a row a sweep picked
        # in the first step came alive instead); the EMA moves others less
        moved = set(torch.nonzero((model.quantize.ema_codebook - start).norm(dim=-1) > 0.5)
                    .flatten().tolist())
        assert moved and moved <= set(REVIVED), moved


# ------------------------------------------------------------ BERT dropout --

def dropout_config(rate: float, **train):
    """The tiny config with text_dropout_in_train and BERT dropout ``rate``."""
    jcfg = jax_config(**train)
    text = dataclasses.replace(jcfg.model.text, hidden_dropout=rate, attention_dropout=rate)
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, text=text, text_dropout_in_train=True))


def test_text_dropout_at_rate_zero_matches_jax():
    """With both rates 0 the variant's two unpacked BERT forwards are the
    deterministic one: metrics, gradients and usage equal JAX's training
    forward with text_dropout_in_train."""
    jcfg = dropout_config(0.0)
    jmodel = JaxTokenizer(jcfg.model)
    batch, _ = host_batch()
    jstate = jax_state(jcfg, jmodel, batch)
    grad_fn = jax.jit(lambda p, u, b: jax.value_and_grad(jax_loss_fn, has_aux=True)(
        p, u, jmodel, b, jax.random.PRNGKey(3), jcfg, None))
    (_, (want, want_usage)), jgrads = grad_fn(jstate.params, jstate.usage,
                                              jax.tree.map(jnp.asarray, batch))
    cfg = port_config(jcfg)
    assert cfg.model.text_dropout_in_train
    model = port_state(cfg, jstate).model.train()
    loss, got = _loss_fn(model, CodeBatch(*batch).to("cpu"), cfg,
                         generator=torch.Generator().manual_seed(0))
    loss.backward()
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5, abs=2e-6), k
    assert_grads_match(model, jgrads, tol=1e-4, zero_tol=1e-6)
    assert_usage_matches(model, want_usage)


def test_bert_dropout_keep_rate_scale_and_generator():
    """At rate 0.3 on the embeddings' output (no layers): about 70% kept,
    each kept value the deterministic one / 0.7; one generator state, one
    mask; another state, another mask. Dropout with segments raises."""
    cfg = TextEncoderConfig(vocab_size=100, hidden_size=64, num_layers=0, num_heads=4,
                            intermediate_size=64, max_position_embeddings=64,
                            hidden_dropout=0.3, attention_dropout=0.3)
    bert = init_random_(BertEncoder(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    ids = torch.randint(1, 100, (8, 40), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    det = bert(ids, mask)
    a = bert(ids, mask, generator=torch.Generator().manual_seed(2), dropout=True)
    b = bert(ids, mask, generator=torch.Generator().manual_seed(2), dropout=True)
    c = bert(ids, mask, generator=torch.Generator().manual_seed(3), dropout=True)
    kept = a != 0
    assert 0.66 < float(kept.float().mean()) < 0.74
    torch.testing.assert_close(a[kept], det[kept] / 0.7, rtol=1e-6, atol=0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="unpacked"):
        bert(ids, None, segments=torch.ones_like(ids, dtype=torch.int32), dropout=True)
    # with layers, every site draws: the output is no mask of the
    # deterministic one, and a rate of 0 is the identity
    deep = init_random_(BertEncoder(dataclasses.replace(cfg, num_layers=2),
                                    dtype=torch.float32), torch.Generator().manual_seed(0))
    out = deep(ids, mask, generator=torch.Generator().manual_seed(2), dropout=True)
    assert not torch.allclose(out, deep(ids, mask), atol=1e-2)
    zero = init_random_(BertEncoder(dataclasses.replace(cfg, num_layers=2, hidden_dropout=0.0,
                                                        attention_dropout=0.0),
                                    dtype=torch.float32), torch.Generator().manual_seed(0))
    assert torch.equal(zero(ids, mask, generator=torch.Generator(), dropout=True),
                       zero(ids, mask))


def test_text_dropout_views_differ_and_packed_raises(monkeypatch):
    """forward_train with text dropout: the augmented view's [CLS] comes
    from a second dropout forward (differs from the clean view's), the
    same generator state repeats both; packed text raises."""
    jcfg = dropout_config(0.1)
    cfg = port_config(jcfg)
    model = init_random_(MultimodalTokenizer(cfg.model, param_dtype=torch.float32),
                         torch.Generator().manual_seed(0)).train()
    batch, packed = host_batch()
    seen = []

    def spy(z, text_features, graph_nodes, text_mask, node_mask, z_aug, *, generator=None):
        seen.append((z.detach().clone(), z_aug.detach().clone()))
        return {}

    monkeypatch.setattr(model.quantize, "forward_train", spy)
    tb = CodeBatch(*batch).to("cpu")
    s0 = cfg.model.split[0]
    for seed in (0, 0, 1):
        model.forward_train(tb, generator=torch.Generator().manual_seed(seed))
    (z, z_aug), (z2, z_aug2), (z3, _) = seen
    assert not torch.allclose(z[:, :s0], z_aug[:, :s0], atol=1e-4)
    assert torch.equal(z, z2) and torch.equal(z_aug, z_aug2) and not torch.equal(z, z3)
    with pytest.raises(ValueError, match="text_dropout_in_train"):
        model.forward_train(tb, packed=PackedTextBatch(*packed).to("cpu"))
