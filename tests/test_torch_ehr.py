"""Port vs JAX: the EHR featurizer, multi-head attention (dense and flash),
the EHR model's eval logits with weights carried by convert.py, the weighted
batch order, the LR schedule, the losses and the numpy metrics (against
sklearn)."""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, f1_score, roc_auc_score

from medtok_tpu.data.synthetic import synthetic_code_vocab
from medtok_tpu.ehr import train as jtrain
from medtok_tpu.ehr.dataset import time_format as jax_time_format
from medtok_tpu.ehr.model import EHRModel as JaxEHRModel
from medtok_tpu.ehr.parsers import MIMIC3Dataset
from medtok_tpu.ehr.synthetic import synthetic_mimic3
from medtok_tpu.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels
from medtok_tpu.models.layers import MultiheadAttention as JaxMHA
from medtok_tpu_torch.convert import flax_params_to_state_dict, load_params
from medtok_tpu_torch.ehr import train
from medtok_tpu_torch.ehr.dataset import time_format
from medtok_tpu_torch.ehr.model import EHRModel, to_device
from medtok_tpu_torch.models.layers import MultiheadAttention

# fp32 paths compute the same arithmetic in another summation order; the
# "default" flash path rounds q/k/v and the probabilities to bf16 on both
# sides at different points of the online softmax (see test_torch_flash3).
ATOL = {"highest": 1e-5, "default": 2e-2}
MAX_VISITS, MAX_CODES = 10, 64          # L = 67, a multiple of no block size


@pytest.fixture(scope="module")
def ehr_data(tmp_path_factory):
    """Task samples from the synthetic MIMIC-III tables through the JAX
    parsers and task builder, featurized by the JAX featurizer."""
    d = tmp_path_factory.mktemp("ehr_port")
    rng = np.random.default_rng(0)
    synthetic_code_vocab(str(d / "codes.parquet"), rng, num_codes=60, num_nodes=300)
    mapper = CodeMapper(d / "codes.parquet")
    synthetic_mimic3(d / "MIMIC_III", [str(c) for c in mapper.df["med_code"]],
                     num_patients=40, seed=1)
    db = MIMIC3Dataset(d / "MIMIC_III")
    data = PatientEHRTasks(db.patients, mapper, dataset="MIMIC_III").build("readmission")
    labels, num_class = build_labels(data, "readmission")
    feats, fz = jtrain.prepare_task_features(
        data, labels, num_class, "readmission", vocab_size=len(mapper),
        max_visits=MAX_VISITS, max_medical_code=MAX_CODES)
    table = np.random.default_rng(1).normal(size=(len(mapper), 256)).astype(np.float32)
    return dict(data=data, labels=labels, num_class=num_class, feats=feats, fz=fz,
                vocab=len(mapper), table=table)


def test_featurizer_matches_jax(ehr_data):
    d = ehr_data
    feats, fz = train.prepare_task_features(
        d["data"], d["labels"], d["num_class"], "readmission", vocab_size=d["vocab"],
        max_visits=MAX_VISITS, max_medical_code=MAX_CODES)
    assert len(feats) == len(d["feats"])
    for got, want in zip(feats, d["feats"]):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert fz.gender_dict == d["fz"].gender_dict
    assert fz.ethnicity_dict == d["fz"].ethnicity_dict
    got, want = fz.collate(feats[:5]), d["fz"].collate(d["feats"][:5])
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # some codes are padding, some are unmapped (the miss row)
    assert got.pad_mask.any() and (got.codes == d["vocab"]).any()
    for delta in (datetime.timedelta(days=400, hours=5), datetime.timedelta(days=-3),
                  datetime.timedelta(days=12, seconds=7300)):
        assert time_format(delta) == jax_time_format(delta)


def _mha_inputs(seed, B=3, L=67, E=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, E)).astype(np.float32)
    lens = np.array([L, 3, 40])
    return x, np.arange(L)[None] < lens[:, None]


@pytest.mark.parametrize("use_flash,precision", [
    (False, "highest"), (True, "highest"), (True, "default")])
def test_multihead_attention_matches_jax(use_flash, precision):
    x, mask = _mha_inputs(0)
    jm = JaxMHA(32, 2, 0.5, use_flash=use_flash, flash_precision=precision)
    args = (jnp.asarray(x),) * 3 + (jnp.asarray(mask),)
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    want = jm.apply({"params": params}, *args, deterministic=True)
    model = MultiheadAttention(32, 2, dropout=0.5, use_flash=use_flash,
                               flash_precision=precision)
    model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                          strict=True)
    model.eval()   # eval: no dropout on either side
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt, xt, xt, torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL[precision], rtol=0)


def _ehr_models(d, use_flash, precision):
    kw = dict(input_dim=32, output_dim=32, num_heads=2, hidden_dim=64, num_layers=2,
              use_flash=use_flash, flash_precision=precision)
    batch = d["fz"].collate(d["feats"][:6])
    jm = JaxEHRModel(embedding_table=jnp.asarray(d["table"]), num_class=d["num_class"],
                     **kw)
    params = jm.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
                     batch, train=False)["params"]
    model = EHRModel(d["table"], d["num_class"], **kw)
    # the whole JAX parameter tree, raw miss_emb / cls_emb leaves included
    load_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model, batch


@pytest.mark.parametrize("use_flash,precision", [
    (False, "highest"), (True, "highest"), (True, "default")])
def test_ehr_model_eval_logits_match_jax(ehr_data, use_flash, precision):
    jm, params, model, batch = _ehr_models(ehr_data, use_flash, precision)
    emb_w, logits_w = jm.apply({"params": params}, batch, train=False)
    with torch.no_grad():
        emb_g, logits_g = model.eval()(to_device(batch, "cpu"))
    np.testing.assert_allclose(logits_g.numpy(), np.asarray(logits_w),
                               atol=ATOL[precision], rtol=0)
    np.testing.assert_allclose(emb_g.numpy(), np.asarray(emb_w),
                               atol=ATOL[precision], rtol=0)


def test_convert_takes_the_ehr_tree_strictly(ehr_data):
    _, params, model, _ = _ehr_models(ehr_data, False, "highest")
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, params))
    assert {"miss_emb", "cls_emb", "layer_1.self_attn.q_proj.weight",
            "position_encoder.year_emb.weight", "layer_0.norm2.weight"} <= set(sd)
    np.testing.assert_array_equal(sd["miss_emb"].numpy(), np.asarray(params["miss_emb"]))
    assert set(sd) == set(model.state_dict())   # table and pe are not state
    assert "embedding_table" not in dict(model.named_parameters())


def test_weighted_batches_same_order(ehr_data):
    d = ehr_data
    w = jtrain.sample_weights(d["labels"], "readmission")
    np.testing.assert_array_equal(train.sample_weights(d["labels"], "readmission"), w)
    want = list(jtrain.weighted_batches(d["feats"], w, d["fz"], batch_size=4,
                                        rng=np.random.default_rng(7)))
    got = list(train.weighted_batches(d["feats"], w, d["fz"], batch_size=4,
                                      rng=np.random.default_rng(7)))
    assert len(got) == len(want) == len(d["feats"]) // 4
    for g, wb in zip(got, want):
        np.testing.assert_array_equal(g.codes, wb.codes)
        np.testing.assert_array_equal(g.label_raw, wb.label_raw)


def test_lr_schedule_matches_jax():
    cfg = dict(lr=3e-3, batch_size=8)
    jt = jtrain.EHRTrainer(jtrain.EHRTrainConfig(**cfg), np.zeros((4, 256), np.float32), 2)
    jt._make_tx(steps_per_epoch=7)
    pt = train.EHRTrainer(train.EHRTrainConfig(**cfg), np.zeros((4, 256), np.float32), 2,
                          device="cpu")
    for step in range(0, 25 * 7, 3):
        assert pt.lr_at(step // 7) == pytest.approx(float(jt._lr_schedule(step)), rel=1e-6)
    assert pt.lr_at(12) > pt.lr_at(10)   # periodic: it rises after T_max


@pytest.mark.parametrize("task", ["readmission", "lenofstay", "phenotype"])
def test_task_loss_and_probs_match_jax(task):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=6)]
    want_loss = jtrain.task_loss(task, jnp.asarray(logits), jnp.asarray(onehot))
    want_p = jtrain.task_probs(task, jnp.asarray(logits))
    got_loss = train.task_loss(task, torch.from_numpy(logits), torch.from_numpy(onehot))
    got_p = train.task_probs(task, torch.from_numpy(logits))
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=60)
    # rounded scores: many ties, which the step/trapezoid definitions meet
    p1 = np.round(np.clip(y + rng.normal(0, 0.6, 60), 0, 1), 1)
    probs = np.stack([1 - p1, p1], 1)
    got = train.compute_metrics("readmission", 2, y, probs)
    assert got["auc"] == pytest.approx(roc_auc_score(y, p1), abs=1e-9)
    assert got["aupr"] == pytest.approx(average_precision_score(y, p1), abs=1e-9)
    assert got["f1"] == pytest.approx(f1_score(y, (p1 > 0.5).astype(int)), abs=1e-9)
    assert got == pytest.approx(jtrain.compute_metrics("readmission", 2, y, probs), abs=1e-9)

    ym = rng.integers(0, 2, size=(40, 5))
    ym[:, 4] = 0                                  # a class with no support
    pm = np.round(np.clip(ym + rng.normal(0, 0.5, ym.shape), 0, 1), 2)
    got = train.compute_metrics("phenotype", 5, ym, pm)
    assert got["auc"] == pytest.approx(roc_auc_score(ym, pm, average="micro"), abs=1e-9)
    assert got["aupr"] == pytest.approx(
        average_precision_score(ym, pm, average="micro"), abs=1e-9)
    assert got["f1"] == pytest.approx(
        f1_score(ym, (pm >= 0.2).astype(int), average="weighted", zero_division=0), abs=1e-9)

    yc = rng.integers(0, 3, size=50)                # lenofstay: 1-D class labels
    pc = rng.dirichlet(np.ones(3), size=50)
    assert train.compute_metrics("lenofstay", 3, yc, pc) == pytest.approx(
        jtrain.compute_metrics("lenofstay", 3, yc, pc), abs=1e-9)
