"""Tokenizer training on a (dp 2, tp 2) mesh: four gloo ranks of the port on
the CPU against the JAX package's ``make_mesh(dp=2, tp=2)`` step on four
virtual CPU devices (``tests/test_tp.py``'s 2-D mesh, the tiny config of
``tests/test_torch_dp_train.py``: EMA codebook, revival and the usage
FIFO, packed texts).

The codebook's 90 rows split into blocks [0, 45) and [45, 90): the text
region [0, 30) lies wholly in tp rank 0's block and the graph region
[60, 90) in tp rank 1's, so each specific sweep runs on one rank and the
other joins its gather with +inf candidates. Each step, from the state the
ranks started it in, is held to JAX's: the 22 averaged loss terms within
1e-5 relative (2e-6 absolute), the FIFO equal and the EMA buffers within
1e-6, the averaged gradients within 1e-4 of each tensor's largest (against
a ``shard_map`` of ``_loss_fn`` with ``pmean`` over dp). The parameters
after each step are held to JAX's steps chained from the same start (Adam
state and all) within 1e-5 of each tensor's largest, but for the elements
whose JAX gradient was noise in any step so far (below 1e-6 of the
tensor's largest: Adam moves them by about lr either way). The four ranks
hold bitwise the same state after every step, and their tokens are those
of the port's (dp 2, tp 1) run on the same blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from medtok_tpu.data.types import CodeBatch as JaxCodeBatch
from medtok_tpu.data.types import PackedTextBatch as JaxPackedTextBatch
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.parallel.mesh import DP_AXIS, TP_AXIS, make_mesh, shard_batch
from medtok_tpu.train import trainer as jax_trainer
from medtok_tpu_torch.convert import flax_params_to_state_dict
from tests.test_torch_dp_train import global_batch, grads_err, state_of
from tests.test_torch_ema_codebook import _jax_init_idx as jax_init_idx
from tests.test_torch_train_step import ZERO_GRAD, port_config, variables_of
from tests.test_torch_train_variants import EMA_KEYS, variant_config, variant_state
from tests.torch_dp_ranks import spawn_ranks

WORLD, DP, TP, B, ROWS, STEPS = 4, 2, 2, 16, 2, 2


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    jcfg = variant_config("kmeans-revival", lr=1e-3, max_grad_norm=0.5, packed_text=True,
                          packed_rows_per_shard=ROWS)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, global_batch_size=B, mesh_dp=DP, mesh_tp=TP))
    batches = [global_batch(seed) for seed in range(STEPS)]
    jstate = variant_state(jcfg, JaxTokenizer(jcfg.model), batches[0])
    spec = dict(cfg=dataclasses.asdict(port_config(jcfg)), variables=variables_of(jstate),
                batches=[tuple(np.asarray(a) for a in b) for b in batches],
                kmeans_init_idx=jax_init_idx(2 * B, jcfg.model.quantizer.codebook_size,
                                             jax.random.PRNGKey(0)), tp=TP)
    root = tmp_path_factory.mktemp("tp_train")
    ranks = spawn_ranks("train", WORLD, root / "tp", spec)
    dp_cfg = port_config(dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, mesh_dp=-1, mesh_tp=1)))
    dp_ranks = spawn_ranks("train", DP, root / "dp",
                           {**spec, "cfg": dataclasses.asdict(dp_cfg), "tp": 1})
    return jcfg, jstate, batches, ranks, dp_ranks


def test_ranks_stay_bitwise_equal(tp_run):
    _, _, _, ranks, _ = tp_run
    for k in range(STEPS):
        ref = ranks[0]["steps"][k]
        for r in range(1, WORLD):
            got = ranks[r]["steps"][k]
            for key in ("before", "after"):
                differ = [n for n, t in ref[key].items() if not torch.equal(t, got[key][n])]
                assert not differ, (k, r, key, differ)
            assert all(torch.equal(a, b) for a, b in zip(ref["mu"], got["mu"]))
            assert {n: v for n, v in got["metrics"].items() if n != "steps_per_sec"} == \
                {n: v for n, v in ref["metrics"].items() if n != "steps_per_sec"}
    for r in range(WORLD):   # the tp ranks of a block trained on its rows
        assert [s["local"].input_ids.shape[0] for s in ranks[r]["steps"]] == [B // DP] * STEPS
        for k in range(STEPS):
            np.testing.assert_array_equal(ranks[r]["steps"][k]["local"].input_ids,
                                          ranks[r - r % TP]["steps"][k]["local"].input_ids)
    assert all(torch.equal(r["kmeans"][0], ranks[0]["kmeans"][0]) for r in ranks)


def test_tokens_are_the_dp_only_runs(tp_run):
    _, _, _, ranks, dp_ranks = tp_run
    for r in range(WORLD):
        for k in range(STEPS):
            np.testing.assert_array_equal(ranks[r]["steps"][k]["tokens"],
                                          dp_ranks[r // TP]["steps"][k]["tokens"])


def test_each_step_matches_the_jax_2d_mesh(tp_run):
    jcfg, jstate, batches, ranks, _ = tp_run
    mesh = make_mesh(dp=DP, tp=TP, devices=jax.devices()[:WORLD])
    jmodel = JaxTokenizer(jcfg.model, dp_axis=DP_AXIS, tp_axis=TP_AXIS)
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
    worst = {"metric": 0.0, "grad": 0.0, "param": 0.0}
    chain, noise = jstate, {}
    for k, b in enumerate(batches):
        step = ranks[0]["steps"][k]
        packed = JaxPackedTextBatch(*(np.concatenate(
            [getattr(ranks[r]["steps"][k]["packed"], f) for r in range(0, WORLD, TP)])
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
        want = flax_params_to_state_dict(jax.tree.map(
            np.asarray, grads_fn(start.params, start.usage, jb, jp)))
        worst["grad"] = max(worst["grad"], grads_err(step["grads"], want))
        chain, _ = jstep(chain, jb, jp)
        params = flax_params_to_state_dict(jax.tree.map(np.asarray, chain.params))
        for name in step["grads"]:
            g = want[name].numpy()
            ref = want[name.replace("bias", "weight")].numpy() if name.endswith(ZERO_GRAD) \
                else g
            noise[name] = noise.get(name, False) | (np.abs(g) < 1e-6 * np.abs(ref).max())
            keep = ~noise[name]
            p, w = after[f"param {name}"].numpy(), params[name].numpy()
            err = np.abs(p - w)[keep].max(initial=0.0) / np.abs(w).max()
            assert err <= 1e-5, (k, name, err)
            worst["param"] = max(worst["param"], float(err))
    assert worst["grad"] <= 1e-4, worst
