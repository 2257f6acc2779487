"""The GAT graph encoder, port vs JAX on the CPU in fp32 with the JAX
weights passed through convert.py:

- ``GATConv`` forward and its gradients with respect to x and every
  parameter within 1e-5 of each tensor's largest element, concatenated and
  averaged heads, on edges with padding (weight 0);
- padded edges add nothing wherever they point, and a node with only its
  self-loop gets its own projection plus the bias;
- ``GraphEncoder("GAT")`` at Ln 16 and at Ln 64 (where the GCN takes the
  dense adjacency), building no adjacency, and bf16 against JAX's bf16
  encoder within a stated tolerance;
- the init: glorot-uniform attention vectors, zero bias, conv2 reading
  hidden * heads;
- another model name raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import GraphEncoderConfig as JaxGraphConfig
from medtok_tpu.data.synthetic import random_code_batch
from medtok_tpu.models.graph_encoder import GraphEncoder as JaxGraphEncoder
from medtok_tpu.models.layers import GATConv as JaxGATConv
from medtok_tpu_torch.config import GraphEncoderConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.models import graph_encoder as graph_encoder_mod
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES, GraphEncoder
from medtok_tpu_torch.models.layers import GATConv, init_random_

N, E, DIN = 24, 60, 6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edges(seed: int = 0):
    """x [N, DIN] and N..E edges, a fifth of them padding (weight 0), node
    N - 1 with no incoming or outgoing edge."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    src = rng.integers(0, N - 1, E)
    dst = rng.integers(0, N - 1, E)
    w = (rng.random(E) > 0.2).astype(np.float32)
    return x, src, dst, w


def _jax_conv(C, H, concat, x, src, dst, w):
    """A JAX GATConv with its params moved off the init (a nonzero bias)."""
    jm = JaxGATConv(C, num_heads=H, concat_heads=concat)
    params = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, (x, src, dst, w)))["params"]
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    params = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(keys[0], a.shape), params)
    return jm, params


def _port_conv(C, H, concat, params):
    m = GATConv(DIN, C, H, concat_heads=concat, dtype=torch.float32)
    m.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return m


@pytest.mark.parametrize("H,C,concat", [(4, 8, True), (4, 8, False), (1, 16, True)])
def test_gat_conv_and_gradients_match_jax(H, C, concat):
    x, src, dst, w = _edges()
    jm, params = _jax_conv(C, H, concat, x, src, dst, w)
    cot = np.random.default_rng(1).normal(size=(N, H * C if concat else C)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w)) * cot)

    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, (x, src, dst, w))))
    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    m = _port_conv(C, H, concat, params)
    xt = _t(x).requires_grad_(True)
    out = m(xt, _t(src), _t(dst), _t(w))
    (out * _t(cot)).sum().backward()
    assert np.abs(out.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    pairs = [("x", xt.grad.numpy(), np.asarray(jg_x))]
    want_g = flax_params_to_state_dict(jax.tree.map(np.asarray, jg_p))
    pairs += [(n, p.grad.numpy(), want_g[n].numpy()) for n, p in m.named_parameters()]
    assert len(pairs) == 5
    for name, g, wg in pairs:
        assert np.abs(wg).max() > 0, name
        err = np.abs(g - wg).max() / np.abs(wg).max()
        assert err <= 1e-5, (name, err)


def test_padded_edges_add_nothing_and_a_lone_node_sees_itself():
    """Moving the padded edges elsewhere changes nothing; node N - 1 (only
    its self-loop) is its own projection plus the bias, as in JAX."""
    x, src, dst, w = _edges()
    jm, params = _jax_conv(8, 4, True, x, src, dst, w)
    m = _port_conv(8, 4, True, params)
    with torch.no_grad():
        base = m(_t(x), _t(src), _t(dst), _t(w))
        pad = w == 0
        src2, dst2 = src.copy(), dst.copy()
        src2[pad], dst2[pad] = N - 1, 0
        moved = m(_t(x), _t(src2), _t(dst2), _t(w))
        lone = m.lin(_t(x[N - 1:])).reshape(-1) + m.bias
    np.testing.assert_array_equal(base.numpy(), moved.numpy())
    np.testing.assert_allclose(base[N - 1].numpy(), lone.numpy(), rtol=0, atol=1e-6)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, (x, src2, dst2, w))))
    np.testing.assert_allclose(moved.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _encoder_case(max_nodes: int, dtype: str = "float32"):
    rng = np.random.default_rng(max_nodes)
    b = random_code_batch(rng, batch=5, text_len=8, max_nodes=max_nodes,
                          max_edges_per_graph=3 * max_nodes, num_kg_nodes=500)
    cfg = dict(num_nodes=500, in_channels=8, hidden_channels=16, out_channels=16,
               model_name="GAT", gat_num_heads=4)
    args = (b.node_ids, b.edge_src, b.edge_dst, b.edge_weight)
    jmodel = JaxGraphEncoder(JaxGraphConfig(**cfg), dtype=jnp.dtype(dtype))
    params = jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    model = GraphEncoder(GraphEncoderConfig(**cfg), dtype=tdt, param_dtype=torch.float32)
    model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                          strict=True)
    return model, args, want


@pytest.mark.parametrize("max_nodes", [16, DENSE_ADJ_MIN_NODES])
def test_gat_encoder_matches_jax_without_an_adjacency(max_nodes, monkeypatch):
    def no_adjacency(*a, **k):
        raise AssertionError("the GAT encoder built a dense adjacency")

    monkeypatch.setattr(graph_encoder_mod, "gcn_norm_adj", no_adjacency)
    model, args, want = _encoder_case(max_nodes)
    assert model.conv2.lin.in_features == 16 * 4
    with torch.no_grad():
        got = model(*map(_t, args))
    assert [g.shape for g in got] == [(5, max_nodes, 64), (5, max_nodes, 16)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_gat_encoder_bf16_within_tolerance():
    """bf16 compute over fp32 parameters. JAX scatter-adds the messages in
    bf16 on the CPU; the port's ``index_put_`` sums as torch does on the
    device at hand. Held within 2^-6 of each output's largest element."""
    model, args, want = _encoder_case(16, "bfloat16")
    with torch.no_grad():
        got = model(*map(_t, args))
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2.0 ** -6, err


def test_gat_init_and_names():
    model = GraphEncoder(GraphEncoderConfig(num_nodes=50, in_channels=8, hidden_channels=16,
                                            out_channels=16, model_name="GAT"))
    init_random_(model, torch.Generator().manual_seed(0))
    jp = JaxGraphEncoder(JaxGraphConfig(num_nodes=50, in_channels=8, hidden_channels=16,
                                        out_channels=16, model_name="GAT")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros(4, jnp.int32),
        jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.float32))["params"]
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jp))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for name in ("conv1.att_src", "conv1.att_dst", "conv2.att_src"):
        H, C = got[name].shape
        limit = np.sqrt(6.0 / (H + C))
        assert 0 < got[name].abs().max() <= limit, name
        assert np.abs(want[name].numpy()).max() <= limit, name
    assert not got["conv1.bias"].any() and not got["conv2.bias"].any()
    with pytest.raises(ValueError, match="GCN' or 'GAT'"):
        GraphEncoder(GraphEncoderConfig(model_name="GIN"))
