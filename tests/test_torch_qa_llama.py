"""Port vs JAX: the QA Llama at TINY_LLAMA with LoRA (nonzero lora_b),
weights bridged from the flax tree by ``convert.load_params``: fp32 logits,
the causal and left-padding masks, the KV cache, greedy ``generate`` with
and without eos, ``on_token`` streaming, the top-p filter and
``convert_hf_llama``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.qa import llama as jllama
from medtok_tpu_torch.convert import flax_params_to_state_dict, load_params
from medtok_tpu_torch.qa import llama

RTOL = 1e-5   # of the largest logit
LORA = 4


def jax_tree(cfg, seed: int = 0, lora_scale: float = 0.1):
    """Flax params of ``cfg`` (numpy leaves) with every lora_b drawn nonzero
    from a numpy seed, so the adapters change the outputs."""
    jm = jllama.LlamaModel(cfg)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, jax.device_get(params["params"]))
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_layers):
        for name in cfg.lora_targets if cfg.lora_rank else ():
            node = params[f"layers_{i}"]["self_attn"][name]
            node["lora_b"] = (lora_scale * rng.normal(size=node["lora_b"].shape)).astype(
                np.float32)
    return jm, params


def port_model(cfg, params):
    model = llama.LlamaModel(llama.LlamaConfig(**dataclasses.asdict(cfg)))
    return load_params(model, params).eval()


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jllama.TINY_LLAMA, lora_rank=LORA)
    jm, params = jax_tree(cfg)
    return jm, params, port_model(cfg, params)


def _close(got, want, what: str):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("tied", [False, True])
def test_logits_match_jax_with_left_padding(tied):
    cfg = dataclasses.replace(jllama.TINY_LLAMA, lora_rank=LORA, tie_word_embeddings=tied)
    jm, params = jax_tree(cfg, seed=1)
    model = port_model(cfg, params)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (3, 12))
    mask = np.ones((3, 12), np.int32)
    mask[1, :4] = 0
    mask[2, :11] = 0
    want, _ = jm.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, caches = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    assert caches is None
    _close(got, want, "logits")
    # the hidden route and the head applied apart give the same logits
    with torch.no_grad():
        hidden, _ = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                          return_hidden=True)
        np.testing.assert_array_equal(model.apply_lm_head(hidden).numpy(), got.numpy())


def test_causal_and_padding_masks(pair):
    """A later token and a padded slot change no valid position's logits;
    the port and JAX agree on both edits."""
    jm, params, model = pair
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (2, 10))
    mask = np.ones((2, 10), np.int32)
    mask[1, :3] = 0
    edited = ids.copy()
    edited[:, -1] = (edited[:, -1] + 1) % 512      # the last token
    edited[1, 1] = (edited[1, 1] + 7) % 512        # a padded slot
    with torch.no_grad():
        a, _ = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
        b, _ = model(torch.as_tensor(edited), attention_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(a[0, :-1].numpy(), b[0, :-1].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a[1, 3:-1].numpy(), b[1, 3:-1].numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(a[0, -1].numpy(), b[0, -1].numpy())
    want, _ = jm.apply({"params": params}, jnp.asarray(edited), attention_mask=jnp.asarray(mask))
    _close(b, want, "edited logits")


def test_cached_prefill_and_decode_match_full_forward(pair):
    """Prefill 5 slots of a left-padded row into the cache, then decode one
    token a step: each step's logits equal the full forward's at that slot,
    and JAX's cached route gives the same."""
    jm, params, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(3)
    B, L, P = 2, 9, 5
    ids = rng.integers(0, 512, (B, L))
    mask = np.ones((B, L), np.int64)
    mask[1, :2] = 0
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    with torch.no_grad():
        full, _ = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                        positions=torch.as_tensor(positions))
        Dh = cfg.hidden_size // cfg.num_heads
        caches = [(torch.zeros(B, L, cfg.num_kv_heads, Dh), torch.zeros(B, L, cfg.num_kv_heads, Dh))
                  for _ in range(cfg.num_layers)]
        slot_mask = np.zeros((B, L), np.int64)
        slot_mask[:, :P] = mask[:, :P]
        outs = []
        got, caches = model(torch.as_tensor(ids[:, :P]), attention_mask=torch.as_tensor(slot_mask),
                            positions=torch.as_tensor(positions[:, :P]), caches=caches,
                            cache_pos=0)
        outs.append(got)
        for t in range(P, L):
            slot_mask[:, t] = mask[:, t]
            got, caches = model(torch.as_tensor(ids[:, t:t + 1]),
                                attention_mask=torch.as_tensor(slot_mask),
                                positions=torch.as_tensor(positions[:, t:t + 1]),
                                caches=caches, cache_pos=t)
            outs.append(got)
    stepped = torch.cat(outs, dim=1).numpy()
    _close(stepped[0], full[0].numpy(), "cached row 0")
    _close(stepped[1, 2:], full[1, 2:].numpy(), "cached row 1 (valid slots)")

    jc = [(jnp.zeros((B, L, cfg.num_kv_heads, Dh)), jnp.zeros((B, L, cfg.num_kv_heads, Dh)))
          for _ in range(cfg.num_layers)]
    jmask = np.zeros((B, L), np.int32)
    jmask[:, :P] = mask[:, :P]
    jout, jc = jm.apply({"params": params}, jnp.asarray(ids[:, :P]),
                        attention_mask=jnp.asarray(jmask),
                        positions=jnp.asarray(positions[:, :P]), caches=jc, cache_pos=0)
    _close(stepped[:, :P], jout, "JAX prefill")


def _embeds(seed: int, B: int, L: int, H: int):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, :2] = 0   # a left-padded row
    return emb, mask


def _jax_generate(jm, params, emb, mask, **kw):
    return np.asarray(jllama.generate(jm, params, jnp.asarray(emb), jnp.asarray(mask),
                                      temperature=0.0, **kw))


def _port_generate(model, emb, mask, **kw):
    return llama.generate(model, torch.as_tensor(emb), torch.as_tensor(mask), temperature=0.0,
                          device="cpu", **kw)


def test_greedy_generate_matches_jax(pair):
    jm, params, model = pair
    emb, mask = _embeds(4, 3, 6, 64)
    want = _jax_generate(jm, params, emb, mask, max_new_tokens=8)
    got = _port_generate(model, emb, mask, max_new_tokens=8)
    assert got.shape == (3, 8) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_with_eos_matches_jax(pair):
    """eos = row 0's third token: row 0 stops there and is eos-filled; the
    loop runs on while another row has not finished, and stops early once
    all have (a second eos that every row emits first)."""
    jm, params, model = pair
    emb, mask = _embeds(5, 3, 6, 64)
    free = _port_generate(model, emb, mask, max_new_tokens=8)
    eos = int(free[0, 2])
    want = _jax_generate(jm, params, emb, mask, max_new_tokens=8, eos_token_id=eos)
    got = _port_generate(model, emb, mask, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()

    # every row's first token is eos: one step, then eos fill
    same = np.repeat(emb[:1], 3, axis=0)
    first = int(_port_generate(model, same, np.ones((3, 6), np.int32), max_new_tokens=1)[0, 0])
    steps = []
    got = _port_generate(model, same, np.ones((3, 6), np.int32), max_new_tokens=8,
                         eos_token_id=first, on_token=steps.append)
    assert steps == [first] and got.shape == (3, 1)
    got = _port_generate(model, same, np.ones((3, 6), np.int32), max_new_tokens=8,
                         eos_token_id=first)
    assert (got == first).all() and got.shape == (3, 8)


def test_on_token_streams_the_first_row_as_jax_does(pair):
    jm, params, model = pair
    emb, mask = _embeds(6, 2, 5, 64)
    eos = int(_port_generate(model, emb, mask, max_new_tokens=4)[1, 1])
    for eos_id in (None, eos):
        seen, jseen = [], []
        got = _port_generate(model, emb, mask, max_new_tokens=6, eos_token_id=eos_id,
                             on_token=seen.append)
        want = _jax_generate(jm, params, emb, mask, max_new_tokens=6, eos_token_id=eos_id,
                             on_token=jseen.append)
        np.testing.assert_array_equal(got, want)
        assert seen == jseen == got[0].tolist()


def test_top_p_filter_matches_jax_sample(monkeypatch):
    """The kept set and renormalized probabilities, read from the logits the
    JAX ``sample`` hands to ``jax.random.categorical``."""
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.normal(size=(4, 512))).astype(np.float32)
    jm = jllama.LlamaModel(jllama.TINY_LLAMA)
    # no top_p of 1.0: there the tail kept depends on whether the mass
    # before a token rounds to 1.0, which follows the cumsum's summation
    # order (XLA's and torch's differ)
    for temperature, top_p in ((0.4, 0.9), (1.0, 0.5), (0.7, 0.95)):
        step = jllama._make_decode_fns(jm, temperature, top_p, None)[1].__wrapped__
        jsample = next(c.cell_contents for c in step.__closure__
                       if getattr(c.cell_contents, "__name__", "") == "sample")
        seen = {}

        def categorical(key, lg, axis=-1):
            seen["logits"] = np.asarray(lg)
            return jnp.zeros(lg.shape[0], jnp.int32)

        monkeypatch.setattr(jax.random, "categorical", categorical)
        first = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(0)))
        monkeypatch.undo()
        sorted_idx, filt = llama.top_p_filter(torch.as_tensor(logits), temperature, top_p)
        # log(filt + 1e-12): a dropped token reads log(1e-12) on both sides,
        # a kept one its renormalized probability
        np.testing.assert_allclose(np.log(filt.numpy() + np.float32(1e-12)), seen["logits"],
                                   rtol=1e-5, atol=1e-5)
        n_kept = (filt.numpy() > 0).sum(axis=1)
        assert (n_kept > 1).all() and (n_kept < 512).all()
        np.testing.assert_array_equal(sorted_idx[:, 0].numpy(), first)
        np.testing.assert_array_equal(
            sorted_idx.numpy(), np.argsort(-torch.softmax(torch.as_tensor(logits) / temperature,
                                                          -1).numpy(), axis=-1, kind="stable"))


def test_sampling_draws_only_kept_tokens_and_repeats_from_a_seed(pair):
    _, _, model = pair
    emb, mask = _embeds(8, 2, 5, 64)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return llama.generate(model, torch.as_tensor(emb), torch.as_tensor(mask),
                              max_new_tokens=6, temperature=0.7, top_p=0.9, generator=g,
                              device="cpu")

    a, b = run(3), run(3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(run(3), run(4)) or not np.array_equal(run(4), run(5))
    last = torch.as_tensor((5.0 * np.random.default_rng(9).normal(size=(512, 64))).astype(
        np.float32))
    sorted_idx, filt = llama.top_p_filter(last, 0.7, 0.9)
    kept = {(r, int(t)) for r, t in zip(*np.nonzero(filt.numpy()))}
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = llama.sample(last, 0.7, 0.9, g)
        pos = (sorted_idx == tok[:, None]).int().argmax(dim=1)
        assert all((r, int(p)) in kept for r, p in enumerate(pos))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_convert_hf_llama_matches_jax_then_bridge(dtype):
    cfg = dataclasses.replace(jllama.TINY_LLAMA, num_layers=2)
    g = torch.Generator().manual_seed(0)
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Dh, KV = E // cfg.num_heads, cfg.num_kv_heads
    shapes = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,),
              "lm_head.weight": (V, E)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        shapes.update({
            f"{p}.input_layernorm.weight": (E,), f"{p}.post_attention_layernorm.weight": (E,),
            f"{p}.self_attn.q_proj.weight": (E, E), f"{p}.self_attn.k_proj.weight": (KV * Dh, E),
            f"{p}.self_attn.v_proj.weight": (KV * Dh, E), f"{p}.self_attn.o_proj.weight": (E, E),
            f"{p}.mlp.gate_proj.weight": (I, E), f"{p}.mlp.up_proj.weight": (I, E),
            f"{p}.mlp.down_proj.weight": (E, I)})
    hf = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    got = llama.convert_hf_llama(hf, llama.LlamaConfig(**dataclasses.asdict(cfg)), dtype=dtype)
    tree = jllama.convert_hf_llama(hf, cfg, dtype=None if dtype is None else jnp.bfloat16)
    want = flax_params_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == (dtype or torch.float32), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)
    # and it loads into the model (no LoRA: rank 0 by default)
    model = llama.LlamaModel(llama.LlamaConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(got, strict=True)


def test_remat_gives_the_same_gradients(pair):
    jm, params, _ = pair
    cfg = dataclasses.replace(jllama.TINY_LLAMA, lora_rank=LORA)
    grads = []
    for remat in (False, True):
        model = port_model(dataclasses.replace(cfg, remat=remat), params).train()
        logits, _ = model(torch.as_tensor(np.arange(10)[None] % 512))
        logits.square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
