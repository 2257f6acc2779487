"""Port vs JAX: graph encoder (scatter and dense-adjacency paths),
cross-attention, the eval quantizer and the unpacked eval model, all fp32
with the JAX weights passed through convert.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import GraphEncoderConfig as JaxGraphConfig
from medtok_tpu.config import QuantizerConfig as JaxQuantConfig
from medtok_tpu.data.synthetic import random_code_batch
from medtok_tpu.models.graph_encoder import GraphEncoder as JaxGraphEncoder
from medtok_tpu.models.layers import CrossAttention as JaxCrossAttention
from medtok_tpu.models.quantizer import SoftVQQuantizer as JaxQuantizer
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu_torch.config import (
    GraphEncoderConfig,
    MedTokConfig,
    QuantizerConfig,
)
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.data.types import CodeBatch
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES, GraphEncoder
from medtok_tpu_torch.models.layers import CrossAttention
from medtok_tpu_torch.models.quantizer import SoftVQQuantizer
from medtok_tpu_torch.models.tokenizer_model import PATH_ORDER, MultimodalTokenizer
from tests.test_model import tiny_config

ATOL = 1e-5


def _load(module, params):
    module.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                           strict=True)
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("max_nodes", [16, DENSE_ADJ_MIN_NODES])
def test_graph_encoder_matches_jax(max_nodes):
    rng = np.random.default_rng(0)
    b = random_code_batch(rng, batch=6, text_len=8, max_nodes=max_nodes,
                          max_edges_per_graph=3 * max_nodes, num_kg_nodes=500)
    cfg = dict(num_nodes=500, in_channels=16, hidden_channels=32, out_channels=16)
    args = (b.node_ids, b.edge_src, b.edge_dst, b.edge_weight)
    jmodel = JaxGraphEncoder(JaxGraphConfig(**cfg), dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    model = _load(GraphEncoder(GraphEncoderConfig(**cfg), dtype=torch.float32), params)
    with torch.no_grad():
        got = model(*map(_t, args))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def _features(rng, B=5, Lt=7, Ln=9, D=16):
    zt = rng.normal(size=(B, Lt, D)).astype(np.float32)
    zg = rng.normal(size=(B, Ln, D)).astype(np.float32)
    tm = np.arange(Lt)[None] < rng.integers(2, Lt + 1, size=B)[:, None]
    nm = np.arange(Ln)[None] < rng.integers(1, Ln + 1, size=B)[:, None]
    return zt, zg, tm, nm


def test_cross_attention_matches_jax():
    zt, zg, tm, nm = _features(np.random.default_rng(1))
    args = (zt, zg, tm, nm)
    jmodel = JaxCrossAttention(embed_dim=16, num_heads=4, dropout=0.1, layers=2)
    params = jmodel.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    model = _load(CrossAttention(16, 4, 2, dtype=torch.float32), params)
    with torch.no_grad():
        got = model(*map(_t, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_eval_quantizer_matches_jax():
    rng = np.random.default_rng(2)
    zt, zg, tm, nm = _features(rng)
    z = rng.normal(size=(5, 32)).astype(np.float32)
    args = (z, zt, zg, tm, nm)
    qcfg = dict(codebook_size=90, codebook_embed_dim=16, usage_buffer_size=4096)
    jmodel = JaxQuantizer(JaxQuantConfig(**qcfg), split=(16, 16))
    jargs = tuple(map(jnp.asarray, args))
    variables = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(2), *a,
                                               train=False))(*jargs)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *jargs)
    model = _load(SoftVQQuantizer(QuantizerConfig(**qcfg), (16, 16),
                                  dtype=torch.float32), variables["params"])
    with torch.no_grad():
        got = model(*map(_t, args))
    keys = {"text": ("text_tokens", "specific_embedding_text"),
            "graph": ("graph_tokens", "specific_embedding_graph"),
            "shared_text": ("shared_text_tokens", "shared_text_embedding"),
            "shared_graph": ("shared_graph_tokens", "shared_graph_embedding")}
    for path, (tok, emb) in keys.items():
        np.testing.assert_array_equal(got[path].indices.numpy(), np.asarray(want[tok]))
        np.testing.assert_allclose(got[path].weights.numpy(),
                                   np.asarray(want[tok + "_weights"]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[path].z_q.numpy(), np.asarray(want[emb]),
                                   atol=ATOL, rtol=0)
    assert got["text"].indices.max() < 30 and got["graph"].indices.max() < 30


def test_unpacked_eval_model_matches_jax():
    """The API path: dense-attention BERT per code, graph, quantizer."""
    jcfg = tiny_config()
    rng = np.random.default_rng(3)
    b = random_code_batch(rng, batch=4, text_len=16, max_nodes=8,
                          max_edges_per_graph=12, text_vocab=1000, num_kg_nodes=500)
    jmodel = JaxTokenizer(jcfg)
    jb = jax.tree.map(jnp.asarray, b)
    variables = jax.jit(lambda bb: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        bb, train=False))(jb)
    want = jax.jit(lambda v, bb: jmodel.apply(v, bb, train=False))(variables, jb)

    cfg = MedTokConfig.from_dict({"model": dataclasses.asdict(jcfg)}).model
    model = _load(MultimodalTokenizer(cfg), variables["params"])
    with torch.no_grad():
        got = model(CodeBatch(*map(_t, b)))
    assert PATH_ORDER == ("text", "graph", "shared_text", "shared_graph")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.embedding.numpy(), np.asarray(want.embedding),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=ATOL, rtol=0)
