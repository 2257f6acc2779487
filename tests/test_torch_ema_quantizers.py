"""The stand-alone EMA quantizers of ``ops/ema.py``, port vs JAX on the CPU
in fp32, the state carried across by ``convert.ema_state_from_arrays``:

- ``norm_ema_quantize`` train on and off: equal indices; z_q, loss, the
  new weight and the usage EMA within 1e-6; its argmin goes through K1's
  wrapper at k = 1 (the plain version on CPU tensors);
- ``weight_update``, ``lookup_quantize`` with and without z, and the
  deterministic branches of ``embedding_ema_init``;
- ``revival_quantize`` with the closest anchor, with and without the
  contrastive term, within 1e-5; the random and probrandom anchors and the
  feature pool fed JAX's draws, and their invariants when drawing their own;
- ``maybe_kmeans_init`` from JAX's initial rows, and lazy once initialised;
- two gloo ranks of ``norm_ema_quantize`` (``dp=``) against one device on
  the union batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import ema as jax_ema
from medtok_tpu_torch.convert import ema_state_from_arrays
from medtok_tpu_torch.ops import ema
from tests.torch_dp_ranks import spawn_ranks

C, D, N = 32, 16, 64
# the JAX functions compiled whole: op by op they cost seconds a test
jax_norm_ema = jax.jit(jax_ema.norm_ema_quantize, static_argnames=("train",))
jax_revival = jax.jit(jax_ema.revival_quantize, static_argnames=("anchor", "contras_loss"))


def unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def jax_state(w, cluster=None, avg=None):
    C = w.shape[0]
    return jax_ema.EmbeddingEMAState(
        weight=jnp.asarray(w), cluster_size=jnp.asarray(
            np.zeros(C, np.float32) if cluster is None else cluster),
        embed_avg=jnp.asarray(w if avg is None else avg), initted=jnp.asarray(True))


def port(x):
    return ema_state_from_arrays(jax.tree.map(np.asarray, x))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"w": unit(rng, C, D), "z": rng.normal(size=(4, N // 4, D)).astype(np.float32),
            "cluster": rng.random(C).astype(np.float32)}


@pytest.mark.parametrize("train", [True, False])
def test_norm_ema_quantize_matches_jax(inputs, train, monkeypatch):
    from medtok_tpu_torch.ops import topk_l2

    calls = []
    real = topk_l2.fused_topk_l2
    monkeypatch.setattr(topk_l2, "fused_topk_l2",
                        lambda z, e, *, k: calls.append(k) or real(z, e, k=k))
    js = jax_state(inputs["w"])
    want = jax_norm_ema(jnp.asarray(inputs["z"]), js,
                                     jnp.asarray(inputs["cluster"]), train=train)
    got = ema.norm_ema_quantize(torch.from_numpy(inputs["z"]), port(js),
                                torch.from_numpy(inputs["cluster"]), train=train)
    assert calls == [1]
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert (np.asarray(want.indices).reshape(-1)[:, None] == np.arange(C)).any(0).sum() < C
    for name in ("z_q", "loss", "cluster_size"):
        close(getattr(got, name), getattr(want, name), 1e-6)
    for a, b in zip(got.state, want.state):
        close(a, b, 1e-6)
    assert got.z_q.shape == (4, N // 4, D)


def test_norm_ema_quantize_gradient_is_straight_through(inputs):
    z = torch.from_numpy(inputs["z"]).requires_grad_(True)
    out = ema.norm_ema_quantize(z, port(jax_state(inputs["w"])), torch.zeros(C))
    (out.z_q.sum() + out.loss).backward()
    want = jax.jit(jax.grad(lambda z: (lambda o: o.z_q.sum() + o.loss)(jax_ema.norm_ema_quantize(
        z, jax_state(inputs["w"]), jnp.zeros(C)))))(jnp.asarray(inputs["z"]))
    close(z.grad, want, 1e-6)
    assert not out.state.weight.requires_grad


def test_weight_update_and_lookup(inputs):
    rng = np.random.default_rng(1)
    avg = rng.normal(size=(C, D)).astype(np.float32)
    js = jax_state(inputs["w"], cluster=(rng.random(C) * 5).astype(np.float32), avg=avg)
    close(ema.weight_update(port(js)).weight, jax_ema.weight_update(js).weight, 1e-6)
    idx = np.array([[1, 3, 5], [0, 31, 3]])
    z = rng.normal(size=(2, 3, D)).astype(np.float32)
    for zz in (None, z):
        want = jax_ema.lookup_quantize(js, jnp.asarray(idx),
                                       None if zz is None else jnp.asarray(zz), beta=0.3)
        got = ema.lookup_quantize(port(js), torch.from_numpy(idx),
                                  None if zz is None else torch.from_numpy(zz), beta=0.3)
        for a, b in zip(got, want):
            close(a, b, 1e-7)


def test_embedding_ema_init_branches(inputs):
    key = jax.random.PRNGKey(0)
    for kw in ({"init_weight": inputs["w"]}, {"kmeans_init": True}):
        want = jax_ema.embedding_ema_init(key, C, D, **kw)
        got = ema.embedding_ema_init(C, D, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = ema.embedding_ema_init(C, D, kmeans_init=False,
                               generator=torch.Generator().manual_seed(0))
    assert bool(g.initted) and g.weight.shape == (C, D)
    close(torch.linalg.vector_norm(g.weight, dim=1), np.ones(C), 1e-6)
    assert g.embed_avg is g.weight and not g.cluster_size.any()


def jax_draws(key, anchor: str, n: int, d=None):
    """The draw JAX's ``revival_quantize`` makes from ``key`` for
    ``anchor`` (its first split key, as it splits it)."""
    r1, _ = jax.random.split(key)
    if anchor == "random":
        return (jax.random.randint(r1, (C,), 0, n) if n >= C
                else jax.random.permutation(r1, C)[:n])
    probs = jax.nn.softmax(d.T, axis=1)
    return jax.random.categorical(r1, jnp.log(probs + 1e-12), axis=1)


@pytest.mark.parametrize("anchor,n", [("closest", N), ("random", C // 2), ("probrandom", N)])
def test_revival_quantize_matches_jax(inputs, anchor, n):
    """Each anchor against JAX with the contrastive term; the port without
    it too (JAX's term aside, the same result)."""
    rng = np.random.default_rng(2)
    z = inputs["z"].reshape(N, D)[:n]
    prob = (rng.random(C) / C).astype(np.float32)
    prob[::2] = 0.0                      # of these, the ones the batch leaves unused revive
    key = jax.random.PRNGKey(3)
    pool = jax_ema.feature_pool_init(jax.random.PRNGKey(4), C, D)
    js = jax_state(inputs["w"])
    want = jax_revival(key, jnp.asarray(z), js, jnp.asarray(prob), pool,
                       anchor=anchor, contras_loss=True)
    draw = None
    if anchor != "closest":
        zn = z / np.linalg.norm(z, axis=-1, keepdims=True)
        d = -jax_ema.squared_distance(jnp.asarray(zn), js.weight)
        draw = torch.from_numpy(np.array(jax_draws(key, anchor, n, d)))
    for contras in (True, False):
        got = ema.revival_quantize(torch.from_numpy(z), port(js), torch.from_numpy(prob),
                                   port(pool), anchor=anchor, contras_loss=contras, draw=draw)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        for name in ("z_q", "loss", "embed_prob"):
            close(getattr(got, name), getattr(want, name), 1e-5)
        close(got.contra_loss, want.contra_loss if contras else 0.0, 1e-5)
        for a, b in zip((*got.state, *got.pool), (*want.state, *want.pool)):
            close(a, b, 1e-5)
    assert float(want.contra_loss) > 0
    dead = np.setdiff1d(np.arange(0, C, 2), got.indices.numpy())
    assert len(dead)
    moved = torch.linalg.vector_norm(got.state.weight - torch.from_numpy(inputs["w"]), dim=1)
    assert float(moved[dead].min()) > 0.1


def test_feature_pool_matches_jax_draws_and_keeps_invariants():
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(6)
    u = np.asarray(jax.random.uniform(key, (C, D)))
    want = jax_ema.feature_pool_init(key, C, D)
    got = ema.feature_pool_init(C, D, uniform=torch.from_numpy(u.copy()))
    close(got.features, want.features, 0)
    assert int(got.num) == 0
    for n in (C // 4, 2 * C):
        f = rng.normal(size=(n, D)).astype(np.float32)
        draw = np.asarray(jax_draws(jax.random.PRNGKey(n), "random", n))
        r1 = jax.random.split(jax.random.PRNGKey(n))[0]
        new_w, st_w = jax_ema.feature_pool_query(r1, want, jnp.asarray(f))
        new, st = ema.feature_pool_query(got, torch.from_numpy(f), draw=torch.from_numpy(draw))
        close(new, new_w, 0)
        assert int(st.num) == int(st_w.num)
        # its own draws: every row of the pool is an incoming row or an old one
        g = torch.Generator().manual_seed(n)
        new, st = ema.feature_pool_query(got, torch.from_numpy(f), generator=g)
        rows = {tuple(r) for r in np.concatenate([f, got.features.numpy()]).tolist()}
        assert all(tuple(r) in rows for r in new.tolist())
        taken = sum(tuple(r) in {tuple(x) for x in f.tolist()} for r in new.tolist())
        assert taken == (C if n >= C else n) and int(st.num) == min(n, C)
    g = ema.feature_pool_init(C, D, generator=torch.Generator().manual_seed(0)).features
    assert float(g.abs().max()) <= 1.0 / C


def test_probrandom_draws_its_own_anchor(inputs):
    z = torch.from_numpy(inputs["z"])
    st = port(jax_state(inputs["w"]))
    prob = torch.zeros(C)
    outs = [ema.revival_quantize(z, st, prob, ema.feature_pool_init(C, D), anchor="probrandom",
                                 generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    torch.testing.assert_close(outs[0].state.weight, outs[1].state.weight, rtol=0, atol=0)
    # a codeword the batch left unused (share 0) moves onto one of the samples
    flat = torch.nn.functional.normalize(z.reshape(-1, D), dim=-1)
    dead = np.setdiff1d(np.arange(C), outs[2].indices.numpy())
    near = torch.cdist(outs[2].state.weight[dead], flat).min(dim=1).values
    assert len(dead) and float(near.max()) < 3e-3
    with pytest.raises(ValueError):
        ema.revival_quantize(z, st, prob, ema.feature_pool_init(C, D), anchor="other")


def test_maybe_kmeans_init_is_lazy(monkeypatch):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(40, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    s0 = jax_ema.embedding_ema_init(jax.random.PRNGKey(0), 8, 4, kmeans_init=True)
    want = jax_ema.maybe_kmeans_init(key, s0, jnp.asarray(data))
    init_idx = torch.from_numpy(np.asarray(jax.random.permutation(key, 40)[:8]))
    got = ema.maybe_kmeans_init(port(s0), torch.from_numpy(data), init_idx=init_idx)
    assert bool(got.initted) and not bool(port(s0).initted)
    for a, b in zip(got, want):
        close(a, b, 1e-6)
    monkeypatch.setattr(ema, "kmeans", lambda *a, **k: pytest.fail("k-means ran again"))
    assert ema.maybe_kmeans_init(got, torch.from_numpy(data * 2)) is got


def test_two_gloo_ranks_equal_one_device(inputs, tmp_path):
    rng = np.random.default_rng(8)
    z = rng.normal(size=(2 * N, D)).astype(np.float32)
    st = jax.tree.map(np.asarray, jax_state(inputs["w"]))
    ranks = spawn_ranks("norm_ema", 2, tmp_path, {"z": z, "state": tuple(st),
                                                 "cluster": inputs["cluster"]})
    for train in (True, False):
        one = ema.norm_ema_quantize(torch.from_numpy(z), port(st),
                                    torch.from_numpy(inputs["cluster"]), train=train)
        idx = np.concatenate([r[train]["indices"] for r in ranks])
        np.testing.assert_array_equal(idx, one.indices.numpy())
        for r in ranks:
            close(r[train]["weight"], one.state.weight.numpy(), 1e-6)
            close(r[train]["ema_cluster"], one.cluster_size.numpy(), 1e-6)
        np.testing.assert_array_equal(ranks[0][train]["weight"], ranks[1][train]["weight"])
    assert not np.array_equal(ranks[0][False]["weight"], ranks[0][True]["weight"])
