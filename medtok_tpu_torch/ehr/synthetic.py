"""Synthetic EHR tables in the MIMIC-III, MIMIC-IV and EHRShot schemas
(counterpart of ``medtok_tpu/ehr/synthetic.py``; no PHI).

The draws are the JAX writers', in the same order, and the files are
written by the ``csv`` module as pandas' ``to_csv(index=False)`` writes
them, so one seed gives byte-identical files. The vocabulary becomes an
array once, not on every draw (a draw from a list converts it each time:
minutes at MIMIC-III's scale with a large vocabulary); the draws are the
same.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _write(path: Path, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


# MIMIC-III v1.4's row counts (Johnson et al., "MIMIC-III, a freely accessible
# critical care database", Sci. Data 3:160035, 2016; the table sizes of its
# documentation)
MIMIC3_V14_ROWS = {"PATIENTS": 46_520, "ADMISSIONS": 58_976, "ICUSTAYS": 61_532,
                   "DIAGNOSES_ICD": 651_047, "PROCEDURES_ICD": 240_095,
                   "PRESCRIPTIONS": 4_156_450}


def synthetic_mimic3(root: str | Path, vocab_codes: list[str], *, num_patients: int = 30,
                     seed: int = 0, v14_rates: bool = False) -> None:
    """Write PATIENTS / ADMISSIONS / ICUSTAYS / DIAGNOSES_ICD /
    PROCEDURES_ICD / PRESCRIPTIONS CSVs under ``root`` with codes drawn from
    ``vocab_codes`` (plus a few unmappable ones).

    By default the counts are the JAX writer's (2-5 admissions a patient,
    1-4 diagnoses and 1-3 procedures and prescriptions an admission) and the
    files are byte for byte its. ``v14_rates`` (the port's own option) draws
    each count as 1 plus a Poisson draw with MIMIC-III v1.4's mean rows a
    patient (admissions) or an admission (the other tables;
    ``MIMIC3_V14_ROWS``), and an admission's codes of one table at once."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = np.asarray(vocab_codes)
    if v14_rates:
        n = MIMIC3_V14_ROWS
        mean = {t: n[t] / n["PATIENTS" if t == "ADMISSIONS" else "ADMISSIONS"] for t in n}

        def count(lo: int, hi: int, table: str) -> int:
            return 1 + int(rng.poisson(mean[table] - 1))

        def codes(k: int, unmapped: bool) -> list[str]:
            drawn = rng.choice(vocab, size=k).tolist()
            if not unmapped:
                return drawn
            keep, ids = rng.random(k) > 0.2, rng.integers(100, size=k)
            return [c if ok else f"UNMAPPED{i}" for c, ok, i in zip(drawn, keep, ids)]
    else:
        def count(lo: int, hi: int, table: str) -> int:
            return int(rng.integers(lo, hi))

        def codes(k: int, unmapped: bool) -> list[str]:
            return [str(rng.choice(vocab)) if not unmapped or rng.random() > 0.2
                    else f"UNMAPPED{rng.integers(100)}" for _ in range(k)]

    patients, admissions, icustays = [], [], []
    diagnoses, procedures, prescriptions = [], [], []
    hadm = 1000
    genders = ["M", "F"]
    eths = ["WHITE", "BLACK", "ASIAN", "HISPANIC"]
    for pid in range(num_patients):
        birth_year = int(rng.integers(1930, 1990))
        patients.append({
            "SUBJECT_ID": pid,
            "GENDER": genders[int(rng.integers(2))],
            "DOB": f"{birth_year}-01-15 00:00:00",
            "DOD_HOSP": "",
        })
        n_visits = count(2, 6, "ADMISSIONS")
        t = np.datetime64("2130-01-01") + rng.integers(0, 1000)
        for v in range(n_visits):
            hadm += 1
            stay = int(rng.integers(1, 20))
            admit = t
            disch = t + stay
            t = disch + int(rng.integers(1, 120))
            admissions.append({
                "SUBJECT_ID": pid, "HADM_ID": hadm,
                "ADMITTIME": f"{admit} 10:00:00",
                "DISCHTIME": f"{disch} 15:00:00",
                "HOSPITAL_EXPIRE_FLAG": int(rng.random() < 0.15),
                "ETHNICITY": eths[int(rng.integers(len(eths)))],
            })
            for _ in range(count(1, 3, "ICUSTAYS")):
                icustays.append({
                    "SUBJECT_ID": pid, "HADM_ID": hadm,
                    "ICUSTAY_ID": int(rng.integers(1e6)),
                })
            for code in codes(count(1, 5, "DIAGNOSES_ICD"), False):
                diagnoses.append({"SUBJECT_ID": pid, "HADM_ID": hadm, "ICD9_CODE": code})
            for code in codes(count(1, 4, "PROCEDURES_ICD"), False):
                procedures.append({"SUBJECT_ID": pid, "HADM_ID": hadm, "ICD9_CODE": code})
            for code in codes(count(1, 4, "PRESCRIPTIONS"), True):
                prescriptions.append({"SUBJECT_ID": pid, "HADM_ID": hadm, "NDC": code})

    _write(root / "PATIENTS.csv", patients)
    _write(root / "ADMISSIONS.csv", admissions)
    _write(root / "ICUSTAYS.csv", icustays)
    _write(root / "DIAGNOSES_ICD.csv", diagnoses)
    _write(root / "PROCEDURES_ICD.csv", procedures)
    _write(root / "PRESCRIPTIONS.csv", prescriptions)


def synthetic_mimic4(root: str | Path, vocab_codes: list[str], *, num_patients: int = 20,
                     seed: int = 0) -> None:
    """MIMIC-IV lowercase schema: patients (anchor_age / anchor_year),
    admissions (race), diagnoses_icd / procedures_icd (icd_version),
    prescriptions (ndc)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = np.asarray(vocab_codes)
    patients, admissions = [], []
    diagnoses, procedures, prescriptions = [], [], []
    hadm = 5000
    for pid in range(num_patients):
        anchor_year = int(rng.integers(2110, 2150))
        patients.append({
            "subject_id": pid, "gender": "MF"[int(rng.integers(2))],
            "anchor_age": int(rng.integers(20, 85)),
            "anchor_year": anchor_year, "anchor_year_group": "2110 - 2130",
            "dod": "",
        })
        t = np.datetime64(f"{anchor_year}-01-01") + rng.integers(0, 300)
        for _ in range(int(rng.integers(2, 5))):
            hadm += 1
            stay = int(rng.integers(1, 15))
            admissions.append({
                "subject_id": pid, "hadm_id": hadm,
                "admittime": f"{t} 08:00:00",
                "dischtime": f"{t + stay} 17:00:00",
                "hospital_expire_flag": int(rng.random() < 0.1),
                "race": ["WHITE", "BLACK", "ASIAN"][int(rng.integers(3))],
            })
            t = t + stay + int(rng.integers(1, 90))
            for _ in range(int(rng.integers(1, 4))):
                diagnoses.append({
                    "subject_id": pid, "hadm_id": hadm,
                    "icd_code": str(rng.choice(vocab)),
                    "icd_version": int(rng.choice([9, 10])),
                })
            for _ in range(int(rng.integers(1, 3))):
                procedures.append({
                    "subject_id": pid, "hadm_id": hadm,
                    "icd_code": str(rng.choice(vocab)),
                    "icd_version": int(rng.choice([9, 10])),
                })
            for _ in range(int(rng.integers(1, 3))):
                prescriptions.append({
                    "subject_id": pid, "hadm_id": hadm,
                    "ndc": str(rng.choice(vocab)),
                })
    _write(root / "patients.csv", patients)
    _write(root / "admissions.csv", admissions)
    _write(root / "diagnoses_icd.csv", diagnoses)
    _write(root / "procedures_icd.csv", procedures)
    _write(root / "prescriptions.csv", prescriptions)


def synthetic_ehrshot(root: str | Path, vocab_codes: list[str], *, num_patients: int = 20,
                      seed: int = 0) -> None:
    """EHRShot schema: patients / admissions (start / end, Gender / Race,
    dob) + diagnoses / procedures / prescriptions with code_val columns."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = np.asarray(vocab_codes)
    patients, admissions = [], []
    tables: dict[str, list] = {"diagnoses": [], "procedures": [], "prescriptions": []}
    vid = 9000
    for pid in range(num_patients):
        patients.append({
            "patient_id": pid,
            "dob": f"{int(rng.integers(1940, 2000))}-06-01",
            "Gender": "MF"[int(rng.integers(2))],
            "Race": ["WHITE", "BLACK"][int(rng.integers(2))],
            "dod": "",
        })
        t = np.datetime64("2015-01-01") + rng.integers(0, 1000)
        for _ in range(int(rng.integers(2, 5))):
            vid += 1
            stay = int(rng.integers(1, 10))
            admissions.append({
                "patient_id": pid, "visit_id": vid,
                "start": f"{t} 09:00:00", "end": f"{t + stay} 12:00:00",
            })
            t = t + stay + int(rng.integers(1, 60))
            for table in tables:
                for _ in range(int(rng.integers(1, 3))):
                    tables[table].append({
                        "patient_id": pid, "visit_id": vid,
                        "code_val": str(rng.choice(vocab)),
                        "icd_version": 10,
                    })
    _write(root / "patients.csv", patients)
    _write(root / "admissions.csv", admissions)
    for table, rows in tables.items():
        _write(root / f"{table}.csv", rows)
