"""Data-parallel EHR training: two gloo ranks of the port on the CPU against
the JAX ``EHRTrainer(mesh=make_mesh(dp=2))``, with no dropout anywhere (the
config of ``tests/test_torch_ehr_train.py``: fp32, the ranks' attention
K3's plain version at precision 'highest', JAX's its dense path).

- two Adam steps, each rank on its half of the global batch: the averaged
  loss within 1e-5 relative of the JAX mesh step's, the averaged gradients
  of the first step within 1e-5 of the model's largest gradient (the
  gradient of the global batch's loss), the parameters after the second
  within the rule of ``tests/test_torch_ehr_train.py``; the two ranks'
  gradients and parameters bitwise equal after each step;
- ``EHRTrainer.fit`` on both ranks from fresh weights: the same steps,
  best state and metrics on both;
- ``weighted_batches``: the ranks' blocks are the single-process batches,
  cut in rank order; a batch the world size does not divide raises.
"""

import jax
import numpy as np
import pytest
import torch

from medtok_tpu.ehr import train as jtrain
from medtok_tpu.parallel.mesh import make_mesh, shard_batch
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.ehr import train
from medtok_tpu_torch.parallel.mesh import DataParallel
from tests.test_torch_ehr import MAX_CODES, MAX_VISITS, ehr_data  # noqa: F401
from tests.test_torch_ehr_train import CFG, RTOL, ZERO_GRAD
from tests.torch_dp_ranks import spawn_ranks

WORLD = 2


@pytest.fixture(scope="module")
def dp_run(ehr_data, tmp_path_factory):  # noqa: F811
    d = ehr_data
    batches = [d["fz"].collate(d["feats"][:8]), d["fz"].collate(d["feats"][8:16])]
    feats, fz = train.prepare_task_features(
        d["data"], d["labels"], d["num_class"], "readmission", vocab_size=d["vocab"],
        max_visits=MAX_VISITS, max_medical_code=MAX_CODES)
    mesh = make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    # JAX's dense attention (its flash kernel runs in interpret mode on the
    # CPU, slowly); the ranks take K3's plain version, exact attention too
    jt = jtrain.EHRTrainer(jtrain.EHRTrainConfig(**{**CFG, "flash_attention": False}),
                           d["table"], d["num_class"], mesh=mesh)
    params, opt_state = jax.jit(jt.init)(batches[0])    # flax's eager init: seconds
    labels = d["labels"]
    val = fz.collate([feats[i] for i in list(np.flatnonzero(labels == 1)[:4])
                      + list(np.flatnonzero(labels == 0)[:4])])
    spec = dict(cfg={**CFG, "epochs": 2}, table=d["table"], num_class=d["num_class"],
                params=flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                batches=[tuple(np.asarray(a) for a in b) for b in batches],
                fit_feats=feats, fit_weights=train.sample_weights(labels, "readmission"),
                val=[tuple(val)], featurizer=fz)
    ranks = spawn_ranks("ehr", WORLD, tmp_path_factory.mktemp("dp_ehr"), spec)
    return d, jt, params, opt_state, batches, ranks


def test_two_steps_match_the_jax_mesh(dp_run):
    d, jt, params, opt_state, batches, ranks = dp_run
    mesh = jt.mesh
    rng = jax.random.PRNGKey(0)
    p1, o1, loss1, _ = jt._train_step(params, opt_state, shard_batch(mesh, batches[0]), rng)
    p2, _, loss2, _ = jt._train_step(p1, o1, shard_batch(mesh, batches[1]), rng)
    got = ranks[0]["steps"]
    assert got[0]["loss"] == pytest.approx(float(loss1), rel=RTOL)
    assert got[1]["loss"] == pytest.approx(float(loss2), rel=RTOL)

    b1 = batches[0]

    def loss_fn(p):
        _, logits = jt.model.apply({"params": p}, b1, train=True, rngs={"dropout": rng})
        return jtrain.task_loss("readmission", logits, b1.label_onehot)

    grads = flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                   jax.jit(jax.grad(loss_fn))(params)))
    assert got[0]["grads"].keys() == grads.keys()
    gmax = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(got[0]["grads"][name].numpy(), g.numpy(), rtol=RTOL,
                                   atol=RTOL * gmax, err_msg=f"grad {name}")
    start = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, p2))
    lr = CFG["lr"]
    for key, p in got[1]["params"].items():
        name = key[len("param "):]
        if not key.startswith("param "):
            continue
        if name.endswith(ZERO_GRAD):
            for side in (p, want[name]):
                assert float((side - start[name]).abs().max()) <= 2 * lr * 1.001
            continue
        scale = float(want[name].abs().max()) + 2 * lr
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=RTOL * scale, err_msg=f"param {name}")


def test_ranks_stay_bitwise_equal(dp_run):
    *_, ranks = dp_run
    a, b = ranks
    for sa, sb in zip(a["steps"], b["steps"]):
        assert sa["loss"] == sb["loss"]
        for key in ("grads", "params"):
            assert all(torch.equal(t, sb[key][n]) for n, t in sa[key].items()), key
    assert a["fit_steps"] == b["fit_steps"] > 0
    assert a["best"] == b["best"]
    assert all(torch.equal(t, b["fit_state"][n]) for n, t in a["fit_state"].items())


def test_weighted_batches_are_cut_in_rank_order(ehr_data):  # noqa: F811
    d = ehr_data
    w = train.sample_weights(d["labels"], "readmission")

    def epoch(**kw):
        return list(train.weighted_batches(d["feats"], w, d["fz"], batch_size=8,
                                           rng=np.random.default_rng(3), **kw))

    whole = epoch()
    parts = [epoch(process_index=r, process_count=WORLD) for r in range(WORLD)]
    assert len(whole) == len(d["feats"]) // 8 and all(len(p) == len(whole) for p in parts)
    for k, batch in enumerate(whole):
        for name, arr in zip(batch._fields, batch):
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(getattr(p[k], name)) for p in parts]),
                np.asarray(arr), err_msg=name)
    with pytest.raises(ValueError, match="not divisible by the world size 3"):
        train.EHRTrainer(train.EHRTrainConfig(**CFG), d["table"], d["num_class"],
                         device="cpu", dp=DataParallel(0, 3, torch.device("cpu")))
