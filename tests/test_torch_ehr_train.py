"""Port vs JAX: two Adam steps of the EHR trainer with flash attention at
precision 'highest' (loss, gradients and parameters), and a short fit on
the CPU."""

import jax
import numpy as np
import pytest
import torch

from medtok_tpu.ehr import train as jtrain
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.ehr import train
from tests.test_torch_ehr import MAX_CODES, MAX_VISITS, ehr_data  # noqa: F401

# no dropout anywhere, so both sides compute the same function in fp32
CFG = dict(task="readmission", batch_size=8, num_layers=2, hidden_dim=32,
           input_dim=32, output_dim=32, num_heads=2, max_visits=MAX_VISITS,
           max_medical_code=MAX_CODES, dropout=0.0, pe_dropout=0.0, lr=3e-3,
           flash_attention=True, flash_precision="highest")
RTOL = 1e-5


def _close(got: torch.Tensor, want, scale: float, what: str):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


# The key projections' biases get an exactly zero gradient (the softmax is
# invariant to a per-row shift of its logits): both sides hold fp32 noise
# there, which Adam's first step normalises to about +-lr.
ZERO_GRAD = ("self_attn.k_proj.bias",)


def test_two_adam_steps_match_jax(ehr_data):
    d = ehr_data
    b1 = d["fz"].collate(d["feats"][:8])
    b2 = d["fz"].collate(d["feats"][8:16])
    jt = jtrain.EHRTrainer(jtrain.EHRTrainConfig(**CFG), d["table"], d["num_class"])
    params, opt_state = jt.init(b1)
    rng = jax.random.PRNGKey(0)

    def loss_fn(p):
        _, logits = jt.model.apply({"params": p}, b1, train=True, rngs={"dropout": rng})
        return jtrain.task_loss("readmission", logits, b1.label_onehot)

    grads = flax_params_to_state_dict(jax.tree.map(np.asarray, jax.grad(loss_fn)(params)))
    p1, o1, loss1, _ = jt._train_step(params, opt_state, b1, rng)
    p2, _, loss2, _ = jt._train_step(p1, o1, b2, rng)

    pt = train.EHRTrainer(train.EHRTrainConfig(**CFG), d["table"], d["num_class"],
                          device="cpu")
    assert pt.use_flash
    pt.model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                             strict=True)
    got1, _ = pt.train_step(b1)
    assert float(got1) == pytest.approx(float(loss1), rel=RTOL)
    named = dict(pt.model.named_parameters())
    assert named.keys() == grads.keys()
    # gradients: to 1e-5 of the model's largest, since some entries are
    # differences of nearly equal terms
    gmax = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        _close(named[name].grad, g, gmax, f"grad {name}")
    got2, _ = pt.train_step(b2)
    assert float(got2) == pytest.approx(float(loss2), rel=RTOL)
    # parameters: to 1e-5 of the tensor's scale plus the two steps' reach
    # (2 lr), as an entry whose gradient is near Adam's eps (1e-8) turns
    # fp32 noise into a visible fraction of a step
    start = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, p2))
    for name, p in pt.model.state_dict().items():
        if name.endswith(ZERO_GRAD):
            for side in (p, want[name]):
                assert float((side - start[name]).abs().max()) <= 2 * CFG["lr"] * 1.001
            continue
        _close(p, want[name], float(want[name].abs().max()) + 2 * CFG["lr"],
               f"param {name}")
    # the second step ran at the epoch-1 rate (one step per epoch, as the
    # JAX trainer's default schedule has it)
    assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jt._lr_schedule(1)), rel=1e-6)


def test_fit_and_evaluate_on_cpu(ehr_data):
    d = ehr_data
    cfg = train.EHRTrainConfig(task="readmission", batch_size=8, epochs=2, num_layers=1,
                               hidden_dim=32, input_dim=32, output_dim=32, num_heads=2,
                               max_visits=MAX_VISITS, max_medical_code=MAX_CODES,
                               early_stop_patience=1)
    pt = train.EHRTrainer(cfg, d["table"], d["num_class"], device="cpu")
    assert not pt.use_flash   # "auto" never takes K3 off CUDA
    labels = d["labels"]
    val = [d["fz"].collate([d["feats"][i] for i in
                            list(np.flatnonzero(labels == 1)[:4])
                            + list(np.flatnonzero(labels == 0)[:4])])]
    w = train.sample_weights(labels, "readmission")
    logged = []
    best_state, best = pt.fit(d["feats"], w, val, d["fz"],
                              log_fn=lambda e, m: logged.append((e, m)))
    assert logged and all(np.isfinite(m["loss"]) for _, m in logged)
    assert pt.step == len(logged) * (len(d["feats"]) // 8)
    assert all(0.0 <= best[k] <= 1.0 for k in ("auc", "aupr", "f1"))
    assert best_state.keys() == pt.model.state_dict().keys()
    pt.model.load_state_dict(best_state)
    assert pt.evaluate(val) == pytest.approx(best)
