"""The port's CodeMapper, the six task builders, build_labels and the task
cache against the JAX package on the MIMIC-III demo fixture (every code of
its tables through both mappers, every task's samples, labels and
num_class), plus the synthetic writers byte for byte."""

import pickle

import numpy as np
import pandas as pd
import pytest

import medtok_tpu.ehr.parsers as jp
import medtok_tpu.ehr.synthetic as js
import medtok_tpu_torch.ehr.parsers as tp
import medtok_tpu_torch.ehr.synthetic as ts
from medtok_tpu.ehr.tasks import CodeMapper as JaxMapper
from medtok_tpu.ehr.tasks import PatientEHRTasks as JaxTasks
from medtok_tpu.ehr.tasks import build_labels as jax_build_labels
from medtok_tpu_torch.data.dataset import write_jsonl
from medtok_tpu_torch.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels
from tests.test_mimic_demo_fixture import FIXTURE
from tests.test_torch_ehr_parsers import ALL_TABLES, _ndc_map, _v

TASKS = ["readmission", "mortality", "lenofstay", "phenotype", "drugrec", "new_disease"]


def fixture_jsonl(path):
    """The fixture's codes.parquet as the .jsonl the card reads."""
    df = pd.read_parquet(FIXTURE / "codes.parquet")
    write_jsonl({c: df[c].tolist() for c in ("med_code", "desc", "pkg_index_list")}, path)
    return path


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    jsonl = fixture_jsonl(tmp_path_factory.mktemp("codes") / "codes.jsonl")
    return dict(
        jdb=jp.MIMIC3Dataset(FIXTURE, tables=ALL_TABLES, ndc_to_atc=_ndc_map()),
        db=tp.MIMIC3Dataset(FIXTURE, tables=ALL_TABLES, ndc_to_atc=_ndc_map()),
        jmap=JaxMapper(FIXTURE / "codes.parquet"),
        map=CodeMapper(jsonl),
        map_parquet=CodeMapper(FIXTURE / "codes.parquet"),
    )


def norm_sample(s: dict) -> dict:
    """A sample with its values typed (NaN equal to NaN)."""
    return {k: (_v(v) if k in ("gender", "ethnicity", "label") else v) for k, v in s.items()}


def test_code_mapper_maps_every_code_as_jax(side):
    codes = {e.code for p in side["jdb"].patients.values() for v in p
             for es in v.event_list_dict.values() for e in es}
    codes |= {c.replace(".", "") for c in codes}
    codes |= {"V302", "8024", "99999", "25000", "", "V30", "V39", "V40", "800", "829"}
    assert len(codes) > 100
    for mapper in (side["map"], side["map_parquet"]):
        assert len(mapper) == len(side["jmap"])
        got = {c: mapper.map(c) for c in sorted(codes)}
        want = {c: side["jmap"].map(c) for c in sorted(codes)}
        assert got == want
        assert -1 in got.values() and got["V302"] >= 0
    for idx in range(len(side["jmap"])):
        assert side["map"].pkg_nodes(idx) == [int(n) for n in side["jmap"].pkg_nodes(idx)]


@pytest.mark.parametrize("task", TASKS)
def test_task_samples_and_labels_match_jax(side, task):
    kw = dict(dataset="MIMIC_III", phenotype_index=FIXTURE / "phenotype_index.pkl")
    want = JaxTasks(side["jdb"].patients, side["jmap"], **kw).build(task)
    got = PatientEHRTasks(side["db"].patients, side["map"], **kw).build(task)
    assert len(got) == len(want) > 0
    assert [[norm_sample(s) for s in d] for d in got] == \
        [[norm_sample(s) for s in d] for d in want]
    labels, num_class = build_labels(got, task)
    jlabels, jnum = jax_build_labels(want, task)
    np.testing.assert_array_equal(labels, jlabels)
    assert num_class == jnum


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_task_cache_reads_across_packages(side, tmp_path, writer):
    """A cache either package wrote reads in the other, with equal samples
    (samples hold builtins and datetimes only)."""
    kw = dict(dataset="MIMIC_III", cache_path=tmp_path / "cache.pkl")
    jt = JaxTasks(side["jdb"].patients, side["jmap"], **kw)
    tt = PatientEHRTasks(side["db"].patients, side["map"], **kw)
    first, second = (jt, tt) if writer == "jax" else (tt, jt)
    written = first.build("mortality")
    assert (tmp_path / "cache.pkl").exists()
    second.patients = {}    # a cache hit must not look at the patients
    read = second.build("mortality")
    assert [[norm_sample(s) for s in d] for d in read] == \
        [[norm_sample(s) for s in d] for d in written]
    with open(tmp_path / "cache.pkl", "rb") as f:
        raw = f.read()
    assert b"pandas" not in raw and b"numpy" not in raw
    pickle.loads(raw)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["synthetic_mimic3", "synthetic_mimic4",
                                  "synthetic_ehrshot"])
def test_synthetic_writers_are_byte_identical(tmp_path, name, seed):
    codes = [f"C{i:05d}" for i in range(40)] + ["250.00", "V30-V39"]
    getattr(js, name)(tmp_path / "jax", codes, num_patients=23, seed=seed)
    getattr(ts, name)(tmp_path / "port", codes, num_patients=23, seed=seed)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) >= 5
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_synthetic_mimic3_at_v14_rates(tmp_path):
    """The port's ``v14_rates`` option: rows a patient and an admission near
    MIMIC-III v1.4's means, files the port's parsers read, readmission
    samples with every code kind."""
    codes = [f"C{i:05d}" for i in range(500)]
    ts.synthetic_mimic3(tmp_path, codes, num_patients=400, seed=3, v14_rates=True)
    rows = {t: len(pd.read_csv(tmp_path / f"{t}.csv")) for t in ts.MIMIC3_V14_ROWS}
    v14 = ts.MIMIC3_V14_ROWS
    assert rows["PATIENTS"] == 400
    assert rows["ADMISSIONS"] / 400 == pytest.approx(v14["ADMISSIONS"] / v14["PATIENTS"],
                                                     rel=0.1)
    for t in ("ICUSTAYS", "DIAGNOSES_ICD", "PROCEDURES_ICD", "PRESCRIPTIONS"):
        assert rows[t] / rows["ADMISSIONS"] == pytest.approx(
            v14[t] / v14["ADMISSIONS"], rel=0.1), t
    rx = pd.read_csv(tmp_path / "PRESCRIPTIONS.csv", dtype={"NDC": str})["NDC"]
    assert rx.str.startswith("UNMAPPED").mean() == pytest.approx(0.2, abs=0.02)
    db = tp.MIMIC3Dataset(tmp_path)
    assert sum(len(p) for p in db.patients.values()) == rows["ADMISSIONS"]
    write_jsonl({"med_code": codes, "desc": codes, "pkg_index_list": [[0]] * len(codes)},
                tmp_path / "codes.jsonl")
    data = PatientEHRTasks(db.patients, CodeMapper(tmp_path / "codes.jsonl")
                           ).build("readmission")
    samples = [s for d in data for s in d]
    assert len(samples) == sum(len(p) - 1 for p in db.patients.values() if len(p) > 1) > 0
    assert all(s["conditions_map"][0][0] and s["drugs_map"][0][0] for s in samples)
