"""The port's pandas-free EHR parsers and code maps against the JAX
package's pandas ones on the CPU: patient by patient (ids, birth and death
times, gender and ethnicity with NaN where pandas has NaN, visits in
order with their times, discharge status value and type and ICU-stay
count, events by table in order) on the MIMIC-III demo fixture with every
table, on the JAX synthetic writers' MIMIC-IV and EHRShot files, and on
hand-made witnesses of each pandas semantic the reader copies."""

import gzip
import json
import math
import sys

import pandas as pd
import pytest

import medtok_tpu.ehr.parsers as jp
import medtok_tpu_torch.ehr.parsers as tp
from chip_smoke import EHR_FIXTURE_COUNTS as FIXTURE_COUNTS
from chip_smoke import EHR_FIXTURE_TABLES as ALL_TABLES
from medtok_tpu.ehr.code_maps import load_code_map as jax_load_code_map
from medtok_tpu.ehr.synthetic import synthetic_ehrshot, synthetic_mimic4
from medtok_tpu_torch.ehr.code_maps import load_code_map, to_atc_level
from medtok_tpu_torch.ehr.table import read_csv, to_datetime
from tests.test_mimic_demo_fixture import FIXTURE

CODES = [f"C{i:05d}" for i in range(40)]


def _v(x):
    """A value with its type; NaN equal to NaN."""
    if isinstance(x, float) and math.isnan(x):
        return ("NaN",)
    return (type(x).__name__, x)


def snapshot(patients: dict) -> list:
    """Everything a parser sets, in order, comparable across the packages'
    dataclasses."""
    out = []
    for key, p in patients.items():
        visits = [(_v(v.visit_id), v.patient_id, v.encounter_time, v.discharge_time,
                   _v(v.discharge_status), v.attr_dict,
                   {t: [(e.code, e.table, _v(e.vocabulary), e.visit_id, e.patient_id,
                         e.timestamp) for e in es] for t, es in v.event_list_dict.items()})
                  for v in p]
        out.append((_v(key), p.patient_id, p.birth_datetime, p.death_datetime,
                    _v(p.gender), _v(p.ethnicity), p.index_to_visit_id, visits))
    return out


def counts(patients: dict) -> dict:
    visits = [v for p in patients.values() for v in p]
    return {"patients": len(patients), "visits": len(visits),
            "events": sum(v.num_events for v in visits)}


def _ndc_map():
    ndc = pd.read_csv(FIXTURE / "ndc_to_atc.csv", dtype=str)
    return dict(zip(ndc["ndc"], ndc["atc"]))


@pytest.mark.parametrize("kw", [
    dict(tables=ALL_TABLES, ndc_to_atc="map"),
    dict(),
    dict(tables=("PRESCRIPTIONS", "LABEVENTS"), dev=True),
], ids=["every-table-atc", "default", "dev"])
def test_mimic3_fixture_matches_jax(kw):
    kw = {k: (_ndc_map() if v == "map" else v) for k, v in kw.items()}
    want = jp.MIMIC3Dataset(FIXTURE, **kw).patients
    got = tp.MIMIC3Dataset(FIXTURE, **kw).patients
    assert snapshot(got) == snapshot(want)
    if kw.get("tables") == ALL_TABLES:   # chip_smoke.py phase 18 holds the card to these
        assert counts(got) == counts(want) == FIXTURE_COUNTS


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("writer,name", [(synthetic_mimic4, "MIMIC4Dataset"),
                                         (synthetic_ehrshot, "EHRShotDataset")])
def test_synthetic_mimic4_and_ehrshot_match_jax(tmp_path, writer, name, seed):
    writer(tmp_path, CODES, num_patients=25, seed=seed)
    for kw in (dict(), dict(ndc_to_atc={CODES[3]: "ATC3", CODES[7]: "ATC7"})):
        want = getattr(jp, name)(tmp_path, **kw).patients
        got = getattr(tp, name)(tmp_path, **kw).patients
        assert snapshot(got) == snapshot(want)
        assert len(got) == 25


def _write(path, text: str, gz: bool = False) -> None:
    if gz:
        with gzip.open(str(path) + ".gz", "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


def _mimic3_witness(root) -> None:
    """Each pandas semantic the reader copies: unsorted ids "999" / "1000"
    (string order), a missing gender and ethnicity (NaN), an 1850 and a
    year-99 date of birth, an unparseable date, a blank and a "NaT"
    discharge, a blank flag (a float status column), a duplicate admission
    row (first wins), visit ids "20" / "3" (string order), an admission of
    no patient, a blank HADM_ID in ICUSTAYS (dropped by groupby), "NA" /
    "N/A" codes (dropped), "NULLX" (kept), events of unknown patients, a
    byte-order mark and .csv.gz tables."""
    _write(root / "PATIENTS.csv",
           "﻿ROW_ID,SUBJECT_ID,GENDER,DOB,DOD_HOSP\n"
           "1,999,M,1850-06-01 00:00:00,\n"
           "2,1000,,2100-01-01 00:00:00,2160-05-05 00:00:00\n"
           "3,42,F,not a date,\n"
           "4,7,F,0099-01-01,\n"
           "\n")
    _write(root / "ADMISSIONS.csv",
           "ROW_ID,SUBJECT_ID,HADM_ID,ADMITTIME,DISCHTIME,HOSPITAL_EXPIRE_FLAG,ETHNICITY\n"
           "1,1000,11,2150-01-01 10:00:00,2150-01-05 12:00:00,0,WHITE\n"
           "2,999,12,2150-02-01 10:00:00,,1,\n"
           "3,1000,13,2150-03-01,NaT,,ASIAN\n"
           "4,42,14,2150-04-01 10:00:00,2150-04-02 10:00:00,0,BLACK\n"
           "5,42,14,2150-04-09 10:00:00,2150-04-10 10:00:00,1,OTHER\n"
           "6,7,20,2150-05-01T08:30:00,2150-05-03 08:30:00.250000,0,WHITE\n"
           "7,7,3,2150-06-01 08:00,2150-06-04,0,WHITE\n"
           "8,555,99,2150-01-01 10:00:00,2150-01-02 10:00:00,0,WHITE\n")
    _write(root / "ICUSTAYS.csv", "SUBJECT_ID,HADM_ID,ICUSTAY_ID\n"
           "1000,11,1\n1000,11,2\n42,14,3\n7,,4\n7,20,5\n", gz=True)
    _write(root / "DIAGNOSES_ICD.csv", "SUBJECT_ID,HADM_ID,SEQ_NUM,ICD9_CODE\n"
           "1000,11,1,4019\n1000,11,2,NA\n999,12,1,N/A\n999,12,2,0010\n"
           "42,14,1,NULLX\n7,20,1,25000\n7,3,1,4280\n555,99,1,4019\n1000,13,1,4019\n")
    _write(root / "PROCEDURES_ICD.csv", "SUBJECT_ID,HADM_ID,SEQ_NUM,ICD9_CODE\n"
           "1000,11,1,3615\n999,12,1,9604\n7,20,1,8964\n7,3,1,9671\n", gz=True)
    _write(root / "PRESCRIPTIONS.csv", "SUBJECT_ID,HADM_ID,NDC\n"
           "1000,11,50000000000\n999,12,123\n7,20,50000000001\n7,3,\n")
    _write(root / "LABEVENTS.csv", "SUBJECT_ID,HADM_ID,ITEMID\n1000,11,51221\n7,3,50912\n")


def _mimic4_witness(root) -> None:
    """A bare-year birth (anchor_year - anchor_age), unsorted admission
    times, ids "999" / "1000", a blank race and an icd_version column with
    a gap (a float column: the row is dropped)."""
    _write(root / "patients.csv",
           "subject_id,gender,anchor_age,anchor_year,anchor_year_group,dod\n"
           "999,M,60,2150,2150 - 2152,\n1000,F,85,2130,2130 - 2132,2135-03-03\n")
    _write(root / "admissions.csv",
           "subject_id,hadm_id,admittime,dischtime,hospital_expire_flag,race\n"
           "999,5,2150-05-01 10:00:00,2150-05-03 10:00:00,0,WHITE\n"
           "999,4,2150-01-01 10:00:00,2150-01-02 10:00:00,0,\n"
           "1000,7,2131-01-01 10:00:00,2131-01-09 10:00:00,1,ASIAN\n")
    _write(root / "diagnoses_icd.csv", "subject_id,hadm_id,icd_code,icd_version\n"
           "999,5,I10,10\n999,4,4019,9\n1000,7,E119,\n1000,7,E11,10\n")
    _write(root / "procedures_icd.csv", "subject_id,hadm_id,icd_code,icd_version\n"
           "999,5,0040,10\n1000,7,3615,9\n", gz=True)
    _write(root / "prescriptions.csv", "subject_id,hadm_id,ndc\n999,5,111\n1000,7,NULL\n")


def _ehrshot_witness(root) -> None:
    """An icd_version column with a gap (vocabulary '10.0' and NaN), a blank
    dob, unsorted codes within a visit."""
    _write(root / "patients.csv", "patient_id,dob,Gender,Race,dod\n"
           "20,1970-06-01,M,WHITE,\n3,,F,,\n")
    _write(root / "admissions.csv", "patient_id,visit_id,start,end\n"
           "20,9002,2015-02-01 09:00:00,2015-02-03 12:00:00\n"
           "3,9001,2015-01-01 09:00:00,2015-01-05 12:00:00\n"
           "20,9003,2015-01-01 09:00:00,2015-01-02 12:00:00\n")
    for table in ("diagnoses", "procedures", "prescriptions"):
        _write(root / f"{table}.csv", "patient_id,visit_id,code_val,icd_version\n"
               "20,9002,ZZ1,10\n20,9002,AA1,\n3,9001,MM2,10\n20,9003,NA,10\n")


@pytest.mark.parametrize("name,make,tables", [
    ("MIMIC3Dataset", _mimic3_witness, ALL_TABLES),
    ("MIMIC4Dataset", _mimic4_witness, ("diagnoses_icd", "procedures_icd", "prescriptions")),
    ("EHRShotDataset", _ehrshot_witness, ("diagnoses", "procedures", "prescriptions")),
])
def test_pandas_semantics_witnesses(tmp_path, name, make, tables):
    make(tmp_path)
    kw = dict(tables=tables, ndc_to_atc={"50000000000": "J01XA01", "111": "B01AB01"})
    want = getattr(jp, name)(tmp_path, **kw).patients
    got = getattr(tp, name)(tmp_path, **kw).patients
    assert snapshot(got) == snapshot(want)
    if name == "MIMIC3Dataset":
        assert list(got) == ["1000", "42", "7", "999"]
        assert got["7"].index_to_visit_id == ["20", "3"]
        assert isinstance(got["1000"].gender, float) and math.isnan(got["1000"].gender)
        assert got["999"].birth_datetime.year == 1850
        assert type(got["1000"][1].discharge_status) is float
        assert got["1000"][0].attr_dict["icustays_num"] == 2
    if name == "MIMIC4Dataset":
        assert got["999"].birth_datetime.year == 2090


def test_csv_reader_types_columns_as_pandas(tmp_path):
    text = ("a,b,c,d,e,f,g,h\n"
            "1,1.5,True,x,NA,007,,1e3\n"
            " 2 ,,false,None,,8,,inf\n"
            "-3,2,TRUE,#N/A,,+9,,.5\n")
    (tmp_path / "t.csv").write_text(text)
    want = pd.read_csv(tmp_path / "t.csv", dtype={"d": str, "f": str})
    got = read_csv(tmp_path / "t.csv", ["d", "f"])
    for col in want.columns:
        assert [_v(x) for x in got[col]] == [_v(x) for x in want[col].tolist()], col


def test_to_datetime_matches_pandas():
    values = ["2150-01-01 10:00:00", "1600-01-01", "1850-07-04", "2300-05-05 00:00:00",
              "2100", "0099-01-01", "garbage", "", "NaT", "nan", "2150-13-01", "1990.0",
              "123", "01/02/2150", "2150-01-01T10:00:00", "2150-01-01 10:00:00.123456",
              "20150102", "2150-01", "2150-1-5", "Jan 5 2150", "2150-02-30", "T"]
    want = pd.to_datetime(pd.Series(values, dtype=object), errors="coerce",
                          format="mixed").dt.to_pydatetime()
    got = [to_datetime(v) for v in values]
    assert got == [None if pd.isna(w) else w for w in want]


def test_to_datetime_without_dateutil_raises_for_a_non_iso_date(monkeypatch):
    """Where dateutil is missing, a date only dateutil reads raises rather
    than turning into NaT; ISO dates and non-dates need no dateutil."""
    monkeypatch.setitem(sys.modules, "dateutil", None)
    monkeypatch.setitem(sys.modules, "dateutil.parser", None)
    assert to_datetime("2150-01-01 10:00:00") == pd.Timestamp("2150-01-01 10:00").to_pydatetime()
    assert to_datetime("123") is None and to_datetime("") is None
    with pytest.raises(ImportError, match="dateutil"):
        to_datetime("Jan 5 2150")


@pytest.mark.parametrize("suffix,text", [
    (".csv", "NDC,ATC,extra\n1,J01,x\n2,,y\n3,B01,z\n"),
    (".tsv", "first\tsecond\n5\tC07\n6\tC10\n"),
    (".csv", "10,N02\n11,A02\n12,NA\n"),
    (".json", json.dumps({"7": "C09", "8": "J01"})),
], ids=["named", "tsv", "headerless", "json"])
def test_load_code_map_matches_jax(tmp_path, suffix, text):
    path = tmp_path / f"map{suffix}"
    path.write_text(text)
    assert load_code_map(path) == jax_load_code_map(path)


def test_fixture_ndc_map_and_atc_levels():
    assert load_code_map(FIXTURE / "ndc_to_atc.csv") == _ndc_map()
    for level in (1, 2, 3, 4, 5):
        assert to_atc_level("J01XA01", level) == "J01XA01"[:{1: 1, 2: 3, 3: 4, 4: 5,
                                                              5: 7}[level]]
