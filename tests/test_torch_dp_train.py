"""Data-parallel tokenizer training: four gloo ranks of the port on the CPU
against the JAX package's 4-device CPU mesh.

- ``epoch_batches(process_index=r, process_count=4)`` equals the JAX
  iterator's, array for array, on the native and the numpy route over two
  epochs with edge dropout (every rank's block padded to the global
  batch's shapes);
- three packed fp32 steps of the tiny config with the EMA codebook,
  revival and the usage FIFO (``packed_rows_per_shard`` set), each rank
  through ``Trainer.fit`` on its block. Each step is held from the state
  the ranks started it in (bridged into JAX) to JAX ``make_train_step`` on
  the mesh fed the concatenated blocks and their packings: the 22 averaged
  loss terms within 1e-5 relative (or 2e-6 absolute, as
  ``tests/test_torch_train_variants.py`` holds them), the usage FIFO equal
  and the EMA buffers within 1e-6; the averaged gradients Adam received
  within 1e-4 of each tensor's largest, against a JAX ``shard_map`` of
  ``_loss_fn`` with ``pmean`` (the rule of
  ``tests/test_torch_train_step.py`` for the key bias). The four ranks
  hold bitwise the same parameters, buffers and Adam moments after every
  step, and their packings are JAX's per-shard packing;
- the automatic row budget: the largest rank's, as the JAX trainer's
  multi-process rule computes it (its ``fit`` driven once a rank with
  ``process_count`` patched to 4);
- the k-means init of a data-parallel run, from the state after the third
  step, clusters the global batch (the ranks' text rows in rank order, then
  their graph rows): every rank holds the EMA codebook within 1e-6 and the
  cluster sizes of JAX ``kmeans_init_codebook`` on the whole first batch,
  the port started from JAX's initial rows.

The ranks run as subprocesses (``tests/torch_dp_ranks.py``), spawned once
for the module.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from medtok_tpu.data.dataset import epoch_batches as jax_epoch_batches
from medtok_tpu.data.packing import pack_code_batch as jax_pack_code_batch
from medtok_tpu.data.synthetic import random_code_batch
from medtok_tpu.data.types import CodeBatch as JaxCodeBatch
from medtok_tpu.data.types import PackedTextBatch as JaxPackedTextBatch
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.parallel.mesh import DP_AXIS, make_mesh, shard_batch
from medtok_tpu.train import trainer as jax_trainer
from medtok_tpu_torch.convert import _RENAME, flatten_tree, flax_params_to_state_dict
from medtok_tpu_torch.data.dataset import epoch_batches
from medtok_tpu.train.trainer import kmeans_init_codebook as jax_kmeans_init_codebook
from tests.test_torch_ema_codebook import _jax_init_idx as jax_init_idx
from tests.test_torch_train_native import datasets  # noqa: F401
from tests.test_torch_train_step import TEXT_LEN, ZERO_GRAD, port_config, variables_of
from tests.test_torch_train_variants import EMA_KEYS, variant_config, variant_state
from tests.torch_dp_ranks import local_block, spawn_ranks

WORLD, B, ROWS, STEPS = 4, 16, 2, 3


# ------------------------------------------------------------- batches -----

@pytest.mark.parametrize("route", ["native", "numpy"])
def test_rank_blocks_equal_jax(datasets, route):  # noqa: F811
    ds, ds_np, jds = datasets
    if route == "numpy":
        ds = ds_np
        jds = jax_numpy_route(jds)
    n = 0
    for epoch in (0, 1):
        for r in range(WORLD):
            kw = dict(batch_size=8, seed=5, epoch=epoch, process_index=r, process_count=WORLD)
            got, want = list(epoch_batches(ds, **kw)), list(jax_epoch_batches(jds, **kw))
            assert len(got) == len(want) == 6
            for g, w in zip(got, want):
                assert g.input_ids.shape[0] == 2
                for name, a, b in zip(g._fields, g, w):
                    assert a.shape == b.shape and a.dtype == b.dtype, name
                    np.testing.assert_array_equal(a, b, err_msg=name)
                n += 1
    assert n == 2 * WORLD * 6
    with pytest.raises(ValueError, match="not divisible"):
        next(epoch_batches(ds, batch_size=6, process_count=WORLD))


def jax_numpy_route(jds):
    """The JAX dataset with its native packer off (its numpy route)."""
    import copy

    out = copy.copy(jds)
    out.native = None
    return out


# ------------------------------------------------------------ the steps ----

def global_batch(seed: int):
    return random_code_batch(np.random.default_rng(seed), batch=B, text_len=TEXT_LEN,
                             max_nodes=8, max_edges_per_graph=8, text_vocab=1000,
                             num_kg_nodes=500)


def port_tree(template, sd: dict) -> dict:
    """The flax params tree of ``template``'s layout holding a port
    state_dict's values (the inverse of ``flax_params_to_state_dict``)."""
    tree: dict = {}
    for path, ref in flatten_tree(template).items():
        *mods, leaf = path.split("/")
        v = sd[".".join(mods + [_RENAME[leaf]])].numpy()
        v = v.T if leaf == "kernel" else v
        assert v.shape == ref.shape, path
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    jcfg = variant_config("kmeans-revival", lr=1e-3, max_grad_norm=0.5, packed_text=True,
                          packed_rows_per_shard=ROWS)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               global_batch_size=B))
    batches = [global_batch(seed) for seed in range(STEPS)]
    jstate = variant_state(jcfg, JaxTokenizer(jcfg.model), batches[0])
    spec = dict(cfg=dataclasses.asdict(port_config(jcfg)), variables=variables_of(jstate),
                batches=[tuple(np.asarray(a) for a in b) for b in batches],
                kmeans_init_idx=jax_init_idx(2 * B, jcfg.model.quantizer.codebook_size,
                                             jax.random.PRNGKey(0)))
    ranks = spawn_ranks("train", WORLD, tmp_path_factory.mktemp("dp_train"), spec)
    return jcfg, jstate, batches, ranks


def test_ranks_stay_bitwise_equal(dp_run):
    _, _, _, ranks = dp_run
    for k in range(STEPS):
        ref = ranks[0]["steps"][k]
        for r in range(1, WORLD):
            got = ranks[r]["steps"][k]
            for key in ("before", "after"):
                differ = [n for n, t in ref[key].items() if not torch.equal(t, got[key][n])]
                assert not differ, (k, r, key, differ)
            assert all(torch.equal(a, b) for a, b in zip(ref["mu"], got["mu"]))
            timed = {"steps_per_sec"}   # each rank's own clock
            assert {k: v for k, v in got["metrics"].items() if k not in timed} == \
                {k: v for k, v in ref["metrics"].items() if k not in timed}
    # the state moved: every step started where the one before ended
    for k in range(1, STEPS):
        prev, cur = ranks[0]["steps"][k - 1]["after"], ranks[0]["steps"][k]["before"]
        assert all(torch.equal(prev[n], cur[n]) for n in prev)


def test_rank_packings_are_jax_shard_packing(dp_run):
    jcfg, _, batches, ranks = dp_run
    for k, b in enumerate(batches):
        want = jax_pack_code_batch(np.asarray(b.input_ids), np.asarray(b.attention_mask),
                                   shards=WORLD, rows_per_shard=ROWS,
                                   row_len=jcfg.train.packed_row_len)
        got = [ranks[r]["steps"][k]["packed"] for r in range(WORLD)]
        for name, w in zip(want._fields, want):
            np.testing.assert_array_equal(np.concatenate([getattr(g, name) for g in got]),
                                          np.asarray(w), err_msg=name)
        for r in range(WORLD):   # the blocks the ranks trained on
            for name, a, w in zip(b._fields, ranks[r]["steps"][k]["local"],
                                  local_block(b, r, WORLD)):
                np.testing.assert_array_equal(a, w, err_msg=name)


def state_of(jstate, before: dict):
    """The JAX state holding the port state the ranks started a step in."""
    sd = {n[len("param "):]: t for n, t in before.items() if n.startswith("param ")}
    usage = {"quantize": {k: jnp.asarray(before[f"buffer quantize.{k}"].numpy())
                          for k in jstate.usage["quantize"]}}
    return jstate.replace(params=port_tree(jstate.params, sd), usage=usage)


def test_each_step_matches_the_jax_mesh(dp_run):
    jcfg, jstate, batches, ranks = dp_run
    mesh = make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    jmodel = JaxTokenizer(jcfg.model, dp_axis=DP_AXIS)
    jstep = jax_trainer.make_train_step(jcfg, jmodel, mesh, donate=False, packed=True)

    def local_grads(params, usage, batch, packed):
        g = jax.grad(lambda p: jax_trainer._loss_fn(
            p, usage, jmodel, batch, jax.random.PRNGKey(0), jcfg, packed)[0])(params)
        return {k: v if k == "text_model" else jax.lax.pmean(v, DP_AXIS)
                for k, v in g.items()}

    sharded = P(DP_AXIS)
    grads_fn = jax.jit(shard_map(
        local_grads, mesh=mesh, check_vma=False, out_specs=P(),
        in_specs=(P(), P(), JaxCodeBatch(*([sharded] * len(JaxCodeBatch._fields))),
                  JaxPackedTextBatch(*([sharded] * len(JaxPackedTextBatch._fields))))))
    worst = {"metric": 0.0, "grad": 0.0, "ema": 0.0}
    for k, b in enumerate(batches):
        step = ranks[0]["steps"][k]
        packed = JaxPackedTextBatch(*(np.concatenate(
            [getattr(ranks[r]["steps"][k]["packed"], f) for r in range(WORLD)])
            for f in JaxPackedTextBatch._fields))
        start = state_of(jstate, step["before"]).replace(step=jnp.asarray(k, jnp.int32))
        jb, jp = shard_batch(mesh, b), shard_batch(mesh, packed)
        new, metrics = jstep(start, jb, jp)
        got = step["metrics"]
        assert set(got) - {"steps_per_sec"} == set(metrics) and len(metrics) == 22
        for name, w in metrics.items():
            w = float(w)
            assert abs(got[name] - w) <= max(1e-5 * abs(w), 2e-6), (k, name, got[name], w)
            worst["metric"] = max(worst["metric"], abs(got[name] - w) / max(abs(w), 1e-6))
        after, usage = step["after"], new.usage["quantize"]
        for name in ("codebook_used", "usage_counts"):
            np.testing.assert_array_equal(after[f"buffer quantize.{name}"].numpy(),
                                          np.asarray(usage[name]), err_msg=f"{k} {name}")
        for name in EMA_KEYS:
            w = np.asarray(usage[name])
            err = np.abs(after[f"buffer quantize.{name}"].numpy() - w).max()
            assert err <= 1e-6 * max(np.abs(w).max(), 1.0), (k, name, err)
            worst["ema"] = max(worst["ema"], float(err))
        want = flax_params_to_state_dict(jax.tree.map(
            np.asarray, grads_fn(start.params, start.usage, jb, jp)))
        worst["grad"] = max(worst["grad"], grads_err(step["grads"], want))
    assert worst["grad"] <= 1e-4, worst


def grads_err(got: dict, want: dict) -> float:
    """The largest gradient error over the tensors, each relative to its
    JAX gradient's largest element; the key bias (exact gradient 0) held
    to 1e-6 of its key weight's gradient on both sides."""
    err = 0.0
    assert set(got) == {n for n in want if not n.startswith("text_model.")}
    for name, g in got.items():
        g, w = g.numpy(), want[name].numpy()
        if name.endswith(ZERO_GRAD):
            scale = np.abs(want[name.replace("bias", "weight")].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * scale, name
            continue
        if not w.any():
            assert not g.any(), name
            continue
        err = max(err, float(np.abs(g - w).max() / np.abs(w).max()))
    return err


def test_row_budget_is_the_largest_ranks(dp_run, monkeypatch):
    """The ranks agreed on the largest of their own budgets, which is the
    budget JAX's fit computes with process_count 4 (each rank's local
    estimate, then the max over the process allgather)."""
    jcfg, _, batches, ranks = dp_run
    assert len({r["budget"] for r in ranks}) == 1
    assert ranks[0]["budget"] == max(r["own"] for r in ranks)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               packed_rows_per_shard=0))
    mesh = make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    trainer = jax_trainer.Trainer(jcfg, JaxTokenizer(jcfg.model, dp_axis=DP_AXIS), mesh)
    from jax.experimental import multihost_utils

    import medtok_tpu.data.packing as jax_packing

    class Budget(Exception):
        pass

    estimates, chosen = [], []

    def allgather(x):
        estimates.append(int(np.asarray(x)[0]))
        return np.asarray([max(r["own"] for r in ranks)])

    def pack(ids, am, *, shards, rows_per_shard, row_len):
        chosen.append(rows_per_shard)
        raise Budget

    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(multihost_utils, "process_allgather", allgather)
    monkeypatch.setattr(jax_packing, "pack_code_batch", pack)
    for r in range(WORLD):
        with pytest.raises(Budget):
            trainer.fit(SimpleNamespace(step=0), [local_block(batches[0], r, WORLD)])
    assert estimates == [r["own"] for r in ranks]
    assert chosen == [ranks[0]["budget"]] * WORLD


def test_kmeans_init_clusters_the_global_batch(dp_run):
    """Every rank holds the EMA codebook and cluster sizes that JAX's
    kmeans_init_codebook leaves on the whole first batch (one process, its
    shared rows text then graph), from the state the ranks ended in."""
    jcfg, jstate, batches, ranks = dp_run
    start = state_of(jstate, ranks[0]["steps"][-1]["after"])
    want = jax_kmeans_init_codebook(JaxTokenizer(jcfg.model), start,
                                    [jax.tree.map(jnp.asarray, batches[0])])
    wu = want.usage["quantize"]
    means, bins = np.asarray(wu["ema_codebook"]), np.asarray(wu["ema_cluster"])
    assert bins.sum() == 2 * B
    for r in ranks:
        np.testing.assert_allclose(r["kmeans"][0].numpy(), means, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(r["kmeans"][1].numpy(), bins)
    assert all(torch.equal(r["kmeans"][0], ranks[0]["kmeans"][0]) for r in ranks)
