"""The EHR downstream as a whole on the CPU: from the CSVs through the port's
chain (parse, tasks, labels, featurize, split, weights) the collated train /
val / test batches equal the JAX chain's; then ``medtok_tpu_torch.cli.ehr``
on the demo fixture and on ``synthetic_mimic3`` writes its metrics, its best
model (which reloads and reproduces the test metrics) and a 2-point
hyper-search; and the chain runs in a process where pandas, pyarrow and
scikit-learn cannot be imported, as on the GPU machine."""

import json
import math
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import medtok_tpu.ehr.parsers as jp
import medtok_tpu_torch.ehr.parsers as tp
from medtok_tpu.ehr.tasks import CodeMapper as JaxMapper
from medtok_tpu.ehr.tasks import PatientEHRTasks as JaxTasks
from medtok_tpu.ehr.tasks import build_labels as jax_build_labels
from medtok_tpu.ehr.train import prepare_task_features as jax_features
from medtok_tpu.ehr.train import sample_weights as jax_weights
from medtok_tpu.ehr.train import stratified_split as jax_split
from medtok_tpu_torch.ehr.synthetic import synthetic_mimic3
from medtok_tpu_torch.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels
from medtok_tpu_torch.ehr.train import (
    EHRTrainer,
    prepare_task_features,
    sample_weights,
    stratified_split,
)
from tests.test_mimic_demo_fixture import FIXTURE
from tests.test_torch_ehr_parsers import _mimic3_witness, _ndc_map
from tests.test_torch_ehr_tasks import fixture_jsonl

REPO = Path(__file__).resolve().parent.parent
TINY = ["--batch-size", "8", "--hidden-dim", "32", "--num-layers", "1", "--num-heads", "2",
        "--input-dim", "16", "--output-dim", "16", "--max-visits", "5",
        "--max-medical-code", "50", "--mesh-dp", "1", "--device", "cpu"]


def _chain(parsers, mapper_cls, tasks_cls, labels_fn, features_fn, split_fn, weights_fn,
           codes, task):
    db = parsers.MIMIC3Dataset(FIXTURE, ndc_to_atc=_ndc_map())
    mapper = mapper_cls(codes)
    data = tasks_cls(db.patients, mapper, dataset="MIMIC_III",
                     phenotype_index=FIXTURE / "phenotype_index.pkl").build(task)
    labels, num_class = labels_fn(data, task)
    feats, fz = features_fn(data, labels, num_class, task, vocab_size=len(mapper),
                            max_visits=6, max_medical_code=40)
    tr, va, te = split_fn(labels, task, seed=42)
    return [fz.collate([feats[i] for i in idx]) for idx in (tr, va, te)], weights_fn(labels, task)


@pytest.mark.parametrize("task", ["readmission", "mortality", "lenofstay", "phenotype",
                                  "drugrec", "new_disease"])
def test_collated_batches_match_jax(tmp_path, task):
    """On the fixture, mortality and lenofstay leave a class with one
    member among the patients' first samples: both splits raise there."""
    port = (tp, CodeMapper, PatientEHRTasks, build_labels, prepare_task_features,
            stratified_split, sample_weights, fixture_jsonl(tmp_path / "c.jsonl"), task)
    jax = (jp, JaxMapper, JaxTasks, jax_build_labels, jax_features, jax_split, jax_weights,
           FIXTURE / "codes.parquet", task)
    if task in ("mortality", "lenofstay"):
        for args in (jax, port):
            with pytest.raises(ValueError, match="only 1 member"):
                _chain(*args)
        return
    got, gw = _chain(*port)
    want, ww = _chain(*jax)
    np.testing.assert_array_equal(gw, ww)
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_missing_demographics_share_one_index_as_in_jax(tmp_path):
    """Patients without a gender or ethnicity carry NaN (one object in a
    string column, as pandas gives it): the featurizer's dictionaries give
    them one index, as the JAX chain does."""
    from medtok_tpu.ehr.dataset import EHRFeaturizer as JaxFeaturizer
    from medtok_tpu_torch.ehr.dataset import EHRFeaturizer

    _mimic3_witness(tmp_path)
    with open(tmp_path / "PATIENTS.csv", "a") as f:
        f.write("5,43,,2100-01-01 00:00:00,\n")
    with open(tmp_path / "ADMISSIONS.csv", "a") as f:
        f.write("9,43,15,2150-01-01 10:00:00,2150-01-05 12:00:00,0,\n")
    out = []
    for parsers, featurizer in ((jp, JaxFeaturizer), (tp, EHRFeaturizer)):
        db = parsers.MIMIC3Dataset(tmp_path)
        fz = featurizer(vocab_size=10, max_visits=4, max_medical_code=8)
        samples = [{"gender": p.gender, "ethnicity": p.ethnicity, "birthdate": None,
                    "conditions_map": [[[1]]], "procedures_map": [[[2]]],
                    "drugs_map": [[[3]]], "timestamp_encounter": [None],
                    "timestamp_discharge": [None]} for p in db.patients.values()
                   for _ in range(2)]
        feats = [fz.featurize(s, np.zeros(2, np.float32), 0) for s in samples]
        out.append([(f["gender"], f["ethnicity"]) for f in feats])
    assert out[0] == out[1]
    genders = [g for g, _ in out[1]]
    assert len(set(genders)) == 3   # M, F and one index for every NaN


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("ehr_cli")
    codes = fixture_jsonl(d / "codes.jsonl")
    n = len(CodeMapper(codes))
    np.save(d / "emb.npy", np.random.default_rng(2).normal(size=(n, 256)).astype(np.float32))
    shutil.copytree(FIXTURE, d / "EHR" / "MIMIC_III")
    with open(codes) as f:
        vocab = [json.loads(line)["med_code"] for line in f]
    synthetic_mimic3(d / "SYN" / "MIMIC_III", vocab, num_patients=40, seed=1)
    return d


def _same(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


@pytest.mark.parametrize("root,task", [("SYN", "readmission"), ("EHR", "new_disease")])
def test_ehr_cli_writes_and_reloads(workspace, tmp_path, root, task):
    from medtok_tpu_torch.cli import ehr as cli

    d = workspace
    common = ["--dataset", "MIMIC_III", "--task", task, "--ehr-root", str(d / root),
              "--med-codes", str(d / "codes.jsonl"), "--embedding-path", str(d / "emb.npy"),
              "--epochs", "2", *TINY]
    out = cli.main([*common, "--save-result-path", str(tmp_path / "res")])
    res = tmp_path / "res"
    tm = json.loads((res / "test_metrics.json").read_text())
    assert {"auc", "aupr", "f1"} <= set(tm["test"]) and tm["task"] == task
    assert _same(tm["test"], out["test"]) and _same(tm["best_val"], out["best_val"])
    lines = [json.loads(line) for line in open(res / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [0, 1, 2] and "test/auc" in lines[-1]
    assert set(out["stages"]) >= {"parse_s", "tasks_s", "featurize_s", "fit_s", "evaluate_s"}
    assert (d / root / "MIMIC_III" / f"MIMIC_III_patient_{task}.pkl").exists()
    # the saved best model reloads into an EHRModel and reproduces the metrics
    table = np.load(d / "emb.npy")
    trainer = EHRTrainer.load(res / "best_model", table, device="cpu")
    state = torch.load(res / "best_model" / "model.pt", weights_only=True)
    assert set(state) == set(trainer.model.state_dict())
    assert _same(trainer.evaluate(out["test_batches"]), out["test"])
    if task == "new_disease":   # both classes in the test batch: finite metrics
        assert all(math.isfinite(v) for v in out["test"].values())

    grid = cli.main([*common, "--save-result-path", str(tmp_path / "grid"), "--hyper-search",
                     "--search-grid", '{"dropout": [0.1, 0.5]}'])
    hs = json.loads((tmp_path / "grid" / "hyper_search.json").read_text())
    assert len(hs["results"]) == 2 == len(grid["results"])
    assert hs["results"][0]["best_val"]["aupr"] >= hs["results"][1]["best_val"]["aupr"]
    assert {r["value"] for r in hs["results"]} == {0.1, 0.5}


def test_ehr_cli_refuses_a_mesh_and_needs_a_device(workspace, monkeypatch):
    from medtok_tpu_torch.cli import ehr as cli

    # data parallel needs torchrun: a plain run's world size is 1
    with pytest.raises(ValueError, match="world size is 1"):
        cli.main(["--mesh-dp", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--ehr-root", str(workspace / "missing")])


def test_ehr_cli_refuses_wandb_at_parse_time(capsys):
    from medtok_tpu_torch.cli import ehr as cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--wandb", "--device", "cpu"])
    assert e.value.code == 2 and "--wandb" in capsys.readouterr().err


def test_ehr_chain_runs_without_pandas_sklearn_or_pyarrow(workspace, tmp_path):
    """The GPU machine's situation: the port's EHR modules and cli.ehr import
    and run on the fixture with pandas, pyarrow and scikit-learn blocked."""
    d = workspace
    script = textwrap.dedent(f"""
        import sys
        for name in ("pandas", "pyarrow", "sklearn", "jax", "medtok_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(REPO)!r})
        import medtok_tpu_torch.ehr as ehr
        from medtok_tpu_torch.ehr import code_maps, memory_bank, synthetic, table, train
        from medtok_tpu_torch.cli import ehr as cli
        from medtok_tpu_torch.api import PretrainedMedTok
        db = ehr.MIMIC3Dataset({str(FIXTURE)!r}, ndc_to_atc=code_maps.load_code_map(
            {str(FIXTURE / "ndc_to_atc.csv")!r}))
        assert len(db.patients) == 120
        out = cli.main(["--dataset", "MIMIC_III", "--task", "readmission",
                        "--ehr-root", {str(d / "SYN")!r}, "--med-codes",
                        {str(d / "codes.jsonl")!r}, "--embedding-path", {str(d / "emb.npy")!r},
                        "--epochs", "1", "--save-result-path", {str(tmp_path / "res")!r},
                        *{TINY!r}])
        assert set(out["test"]) == {{"auc", "aupr", "f1"}}
        assert not any(m in sys.modules and sys.modules[m] is not None
                       for m in ("pandas", "sklearn", "pyarrow", "jax"))
        print("ran without pandas")
    """)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "ran without pandas" in run.stdout
