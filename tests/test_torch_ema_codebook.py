"""The EMA (``--kmeans``) codebook, port vs JAX on the CPU in fp32:

- ``ema_update`` and ``norm_ema_update``;
- ``kmeans`` from JAX's initial indices at n >= C (drawn without
  replacement) and n < C (with replacement: duplicated means, exact ties
  that go to the lowest index), cosine and L2: means and bins within 1e-6;
- the quantizer's EMA buffers after one ``forward_train`` against the JAX
  quantizer's mutated ``usage``, with and without revival, and the sweeps
  reading the codebook as it was before the write;
- ``kmeans_init_codebook`` against JAX's, in the kmeans mode and on the
  codebook parameter;
- ``convert.load_params`` of a kmeans variables tree and of its ``.npz``;
- the mode's parameters: no codebook, the buffers outside the state_dict.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import QuantizerConfig as JaxQuantConfig
from medtok_tpu.models.quantizer import SoftVQQuantizer as JaxQuantizer
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.ops import ema as jax_ema
from medtok_tpu.train.trainer import kmeans_init_codebook as jax_kmeans_init_codebook
from medtok_tpu_torch.config import QuantizerConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict, load_params, save_npz
from medtok_tpu_torch.data.types import CodeBatch
from medtok_tpu_torch.models.quantizer import SoftVQQuantizer
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.ops.ema import ema_update, kmeans, kmeans_init_indices, norm_ema_update
from medtok_tpu_torch.train.trainer import create_train_state, kmeans_init_codebook
from tests.test_torch_train_step import host_batch, jax_config, jax_state, port_config

EMA_KEYS = ("ema_codebook", "ema_cluster", "ema_embed_prob")


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_ema_updates_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 30, 8)).astype(np.float32)
    np.testing.assert_allclose(ema_update(_t(a), _t(b), 0.99).numpy(),
                               np.asarray(jax_ema.ema_update(a, b, 0.99)), rtol=0, atol=1e-7)
    got = norm_ema_update(_t(a), _t(b), 0.9).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ema.norm_ema_update(a, b, 0.9)),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def _jax_init_idx(n: int, c: int, key) -> np.ndarray:
    """The rows ``medtok_tpu.ops.ema.kmeans`` starts from for ``key``."""
    if n >= c:
        return np.asarray(jax.random.permutation(key, n)[:c])
    return np.asarray(jax.random.randint(key, (c,), 0, n))


@pytest.mark.parametrize("n,c", [(200, 12), (12, 40)])
@pytest.mark.parametrize("cosine", [True, False])
def test_kmeans_matches_jax_from_its_initial_means(n, c, cosine):
    rng = np.random.default_rng(n + c)
    samples = _unit(rng, n, 16) if cosine else rng.normal(size=(n, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = _jax_init_idx(n, c, key)
    if n < c:
        assert len(np.unique(idx)) < c          # duplicated means: exact ties
    want_means, want_bins = jax_ema.kmeans(key, jnp.asarray(samples), c, num_iters=10,
                                           use_cosine_sim=cosine)
    means, bins = kmeans(_t(samples), c, 10, cosine, init_idx=_t(idx))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means), rtol=0, atol=1e-6)
    assert bins.sum() == n
    if n < c:
        # the tie-break: a duplicated mean's samples go to its first copy
        first = {}
        for j, i in enumerate(idx):
            first.setdefault(int(i), j)
        assert set(np.flatnonzero(bins.numpy())) <= set(first.values())


def test_kmeans_init_indices_and_generator():
    """Without indices, kmeans draws them on the CPU from the generator:
    one seed, one draw; without replacement at n >= C."""
    g = torch.Generator().manual_seed(5)
    idx = kmeans_init_indices(50, 20, g)
    assert len(set(idx.tolist())) == 20 and idx.max() < 50
    again = kmeans_init_indices(50, 20, torch.Generator().manual_seed(5))
    assert torch.equal(idx, again)
    assert kmeans_init_indices(5, 20).max() < 5
    samples = _t(_unit(np.random.default_rng(0), 50, 8))
    a = kmeans(samples, 20, 3, True, generator=torch.Generator().manual_seed(5))
    b = kmeans(samples, 20, 3, True, init_idx=idx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _quantizer_inputs(seed: int = 0, B: int = 6, D: int = 16):
    rng = np.random.default_rng(seed)
    zt = rng.normal(size=(B, 7, D)).astype(np.float32)
    zg = rng.normal(size=(B, 9, D)).astype(np.float32)
    tm = np.arange(7)[None] < rng.integers(2, 8, size=B)[:, None]
    nm = np.arange(9)[None] < rng.integers(1, 10, size=B)[:, None]
    z = rng.normal(size=(B, 2 * D)).astype(np.float32)
    z_aug = z + 0.1 * rng.normal(size=z.shape).astype(np.float32)
    return z, zt, zg, tm, nm, z_aug


@pytest.mark.parametrize("revival", [False, True])
def test_quantizer_ema_write_matches_jax(revival):
    """One training forward from JAX's state (the EMA codebook moved off
    its placeholder so both bins and empty rows occur): every usage buffer
    against JAX's mutated collection, the outputs too."""
    jcfg = JaxQuantConfig(codebook_size=90, codebook_embed_dim=16, usage_buffer_size=512,
                          cross_attn_dropout=0.0, use_kmeans=True,
                          codebook_revival=revival)
    inputs = _quantizer_inputs()
    args = [jnp.asarray(a) for a in inputs]
    jq = JaxQuantizer(jcfg, split=(16, 16))
    variables = jq.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        *args[:5], z_aug=args[5], train=True)
    usage = jax.tree.map(np.asarray, dict(variables["usage"]))
    usage["ema_codebook"] = _unit(np.random.default_rng(9), 90, 16)
    if revival:
        usage["ema_embed_prob"] = np.random.default_rng(8).random(90).astype(np.float32) / 90
    want, mutated = jq.apply({"params": variables["params"],
                              "usage": jax.tree.map(jnp.asarray, usage)}, *args[:5],
                             z_aug=args[5], train=True, mutable=["usage"],
                             rngs={"dropout": jax.random.PRNGKey(2)})
    want_usage = jax.tree.map(np.asarray, mutated["usage"])

    q = SoftVQQuantizer(port_config_quant(jcfg), (16, 16), dtype=torch.float32)
    assert "codebook" not in dict(q.named_parameters())
    assert not set(EMA_KEYS) & set(q.state_dict())
    load_params(q, {"params": jax.tree.map(np.asarray, variables["params"]),
                    "usage": usage})
    before = q.ema_codebook
    got = q.forward_train(*map(_t, inputs[:5]), _t(inputs[5]))
    keys = EMA_KEYS if revival else EMA_KEYS[:2]
    assert set(want_usage) == {"codebook_used", "usage_counts", *keys}
    for k in keys:
        w = want_usage[k]
        err = np.abs(getattr(q, k).numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (k, err)
    for k in ("codebook_used", "usage_counts"):
        np.testing.assert_array_equal(getattr(q, k).numpy(), want_usage[k])
    assert q.ema_codebook is not before          # a new tensor, the old one intact
    np.testing.assert_array_equal(before.numpy(), usage["ema_codebook"])
    for k in ("text_tokens", "graph_tokens", "shared_text_tokens", "shared_graph_tokens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["shared_text_embedding"].detach().numpy(),
                               np.asarray(want["shared_text_embedding"]), rtol=0, atol=1e-5)
    # rows no feature chose, and with revival whose share is high, keep
    # their codeword up to the EMA's re-normalisation
    assert np.allclose(np.linalg.norm(q.ema_codebook.numpy(), axis=-1), 1.0, atol=1e-5)


def port_config_quant(jcfg) -> QuantizerConfig:
    return QuantizerConfig(**dataclasses.asdict(jcfg))


def _kmeans_cfg(use_kmeans: bool = True, revival: bool = False):
    jcfg = jax_config()
    q = dataclasses.replace(jcfg.model.quantizer, use_kmeans=use_kmeans,
                            codebook_revival=revival)
    return dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, quantizer=q))


@pytest.mark.parametrize("use_kmeans", [True, False])
def test_kmeans_init_codebook_matches_jax(use_kmeans):
    """Two batches of 8: 32 shared rows against 90 codewords, so the JAX
    draw (PRNGKey(0), with replacement) duplicates means."""
    jcfg = _kmeans_cfg(use_kmeans)
    jmodel = JaxTokenizer(jcfg.model)
    batches = [host_batch(seed)[0] for seed in (0, 1)]
    jstate = jax_state(jcfg, jmodel, batches[0])
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    want = jax_kmeans_init_codebook(jmodel, jstate, jb)
    idx = _jax_init_idx(32, 90, jax.random.PRNGKey(0))

    cfg = port_config(jcfg)
    model = MultimodalTokenizer(cfg.model, param_dtype=torch.float32)
    variables = {"params": jax.tree.map(np.asarray, jstate.params),
                 "usage": jax.tree.map(np.asarray, jstate.usage)}
    state = create_train_state(cfg, model, params=variables)
    kmeans_init_codebook(model, state, [CodeBatch(*b) for b in batches], init_idx=_t(idx))
    q = model.quantize
    if use_kmeans:
        wu = want.usage["quantize"]
        np.testing.assert_allclose(q.ema_codebook.numpy(), np.asarray(wu["ema_codebook"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(q.ema_cluster.numpy(), np.asarray(wu["ema_cluster"]))
        assert q.ema_cluster.sum() == 32
    else:
        np.testing.assert_allclose(q.codebook.detach().numpy(),
                                   np.asarray(want.params["quantize"]["codebook"]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("via", ["tree", "npz"])
def test_load_params_fills_the_ema_buffers(via, tmp_path):
    jcfg = _kmeans_cfg(revival=True)
    jmodel = JaxTokenizer(jcfg.model)
    jstate = jax_state(jcfg, jmodel, host_batch()[0])
    usage = jax.tree.map(np.asarray, jstate.usage)
    rng = np.random.default_rng(4)
    usage["quantize"]["ema_codebook"] = _unit(rng, 90, 16)
    usage["quantize"]["ema_cluster"] = rng.random(90).astype(np.float32)
    usage["quantize"]["ema_embed_prob"] = rng.random(90).astype(np.float32)
    variables = {"params": jax.tree.map(np.asarray, jstate.params), "usage": usage}
    assert "codebook" not in variables["params"]["quantize"]
    src = variables
    if via == "npz":
        src = tmp_path / "v.npz"
        save_npz(variables, src)
    model = load_params(MultimodalTokenizer(port_config(jcfg).model,
                                            param_dtype=torch.float32), src)
    q = model.quantize
    for k in EMA_KEYS + ("codebook_used", "usage_counts"):
        np.testing.assert_array_equal(getattr(q, k).numpy(), usage["quantize"][k])
    sd = model.state_dict()
    want = flax_params_to_state_dict(variables["params"])
    assert set(sd) == set(want)
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda a: a, variables)
        bad["usage"]["quantize"]["ema_cluster"] = np.zeros(7, np.float32)
        load_params(model, bad)
