"""EHR dataset parsers: MIMIC-III / MIMIC-IV / EHRShot CSVs -> Patients
(counterpart of ``medtok_tpu/ehr/parsers.py``, read without pandas through
``ehr/table.py``, which reproduces what pandas gives the JAX parsers).

- MIMIC-III: PATIENTS (SUBJECT_ID, GENDER, DOB, DOD_HOSP) x ADMISSIONS
  (HADM_ID, ADMITTIME, DISCHTIME, HOSPITAL_EXPIRE_FLAG, ETHNICITY) x
  ICUSTAYS (per-visit count -> visit.attr_dict['icustays_num']);
  DIAGNOSES_ICD (ICD9CM), PROCEDURES_ICD (ICD9PROC), PRESCRIPTIONS (NDC),
  LABEVENTS (MIMIC3_ITEMID) and ICUSTAYS (icustay) events.
- MIMIC-IV: patients (gender, anchor_year - anchor_age as the birth year),
  admissions (race as ethnicity), diagnoses_icd / procedures_icd with the
  icd_version in the vocabulary, prescriptions (ndc).
- EHRShot: patients / admissions (start / end, Gender / Race, dob) and
  diagnoses / procedures / prescriptions with code_val columns.

Orders: patients in sorted id order, visits in sorted visit-id order per
patient with the fields of the visit's first row, demographics from the
patient's first row, events in file order (EHRShot's sorted by patient,
visit and code). ``ndc_to_atc`` maps drug codes; unmapped codes pass
through.
"""

from __future__ import annotations

from collections import Counter
from datetime import datetime
from pathlib import Path
from typing import Callable

from medtok_tpu_torch.ehr.data import Event, Patient, Visit
from medtok_tpu_torch.ehr.table import (
    Table,
    astype_str,
    isna,
    merge,
    na_key,
    read_csv,
    ts_list,
)


def _read(root: Path, name: str, str_columns=()) -> Table:
    """Read {root}/{name}.csv or .csv.gz."""
    for suffix in (".csv", ".csv.gz"):
        p = root / f"{name}{suffix}"
        if p.exists():
            return read_csv(p, str_columns)
    raise FileNotFoundError(f"{root}/{name}.csv[.gz]")


def _dev_cut(df: Table, subject_col: str) -> Table:
    """The first 1000 patients in row order."""
    keep = list(dict.fromkeys(na_key(v) for v in df[subject_col]))[:1000]
    return df.isin(subject_col, keep)


def _build_patients(
    df: Table,
    *,
    subject_col: str,
    visit_col: str,
    encounter_col: str,
    discharge_col: str,
    status_col: str | None,
    ethnicity_col: str,
    birth_of: Callable[[Table], list[datetime | None]],
    death_of: Callable[[Table], list[datetime | None]],
    gender_col: str,
    icu_counts: dict[str, int] | None = None,
) -> dict[str, Patient]:
    """Patients from the merged frame: demographics from each patient's
    first row, visits in sorted visit-id order with the fields of each
    visit's first row, patients in sorted id order."""
    pat_first = df.drop_duplicates([subject_col])
    patients: dict[str, Patient] = {}
    births = birth_of(pat_first)
    deaths = death_of(pat_first)
    genders = pat_first[gender_col]
    ethnicities = pat_first[ethnicity_col]
    for i, p_id in enumerate(pat_first[subject_col]):
        patients[p_id] = Patient(
            patient_id=p_id,
            birth_datetime=births[i],
            death_datetime=deaths[i],
            gender=genders[i],
            ethnicity=ethnicities[i],
        )

    vis = df.drop_duplicates([subject_col, visit_col]).sort_values([subject_col, visit_col])
    p_ids = vis[subject_col]
    v_ids = astype_str(vis[visit_col])
    enc = ts_list(vis[encounter_col])
    dis = ts_list(vis[discharge_col])
    status = vis[status_col] if status_col else [None] * len(vis)
    for i in range(len(v_ids)):
        v_id = v_ids[i]
        patients[p_ids[i]].add_visit(Visit(
            visit_id=v_id,
            patient_id=p_ids[i],
            encounter_time=enc[i],
            discharge_time=dis[i],
            discharge_status=status[i],
            attr_dict={"icustays_num": icu_counts.get(v_id, 1) if icu_counts else 1},
        ))
    return {k: patients[k] for k in sorted(patients)}


def _ingest_events(
    patients: dict[str, Patient],
    df: Table,
    *,
    table: str,
    subject_col: str,
    visit_col: str,
    code_col: str,
    vocab,  # str, or a list aligned with df's rows
    code_map: dict[str, str] | None = None,
) -> None:
    """One event a row, in row order; rows of unknown patients skipped."""
    p_ids = astype_str(df[subject_col])
    v_ids = astype_str(df[visit_col])
    codes = astype_str(df[code_col])
    if code_map is not None:
        codes = [code_map.get(c, c) for c in codes]
    vocabs = vocab if isinstance(vocab, list) else None
    get = patients.get
    for i in range(len(p_ids)):
        p_id = p_ids[i]
        patient = get(p_id)
        if patient is None:
            continue
        patient.add_event(Event(
            code=codes[i], table=table,
            vocabulary=vocabs[i] if vocabs is not None else vocab,
            visit_id=v_ids[i], patient_id=p_id,
        ))


def _none_column(df: Table, name: str) -> None:
    if name not in df:
        df[name] = [None] * len(df)


class MIMIC3Dataset:
    """MIMIC-III CSVs -> {patient_id: Patient}."""

    def __init__(
        self,
        root: str | Path,
        tables: tuple[str, ...] = ("DIAGNOSES_ICD", "PROCEDURES_ICD", "PRESCRIPTIONS"),
        *,
        ndc_to_atc: dict[str, str] | None = None,
        dev: bool = False,
    ):
        self.root = Path(root)
        self.dev = dev
        self.ndc_to_atc = ndc_to_atc
        self.patients = self._parse_basic()
        parsers: dict[str, Callable] = {
            "DIAGNOSES_ICD": self._parse_diagnoses,
            "PROCEDURES_ICD": self._parse_procedures,
            "PRESCRIPTIONS": self._parse_prescriptions,
            "LABEVENTS": self._parse_labevents,
            "ICUSTAYS": self._parse_icustay_events,
        }
        for t in tables:
            parsers[t]()

    def _parse_basic(self) -> dict[str, Patient]:
        pat = _read(self.root, "PATIENTS", ["SUBJECT_ID"])
        adm = _read(self.root, "ADMISSIONS", ["SUBJECT_ID", "HADM_ID"])
        df = merge(pat, adm, "SUBJECT_ID")
        try:
            icu = _read(self.root, "ICUSTAYS", ["SUBJECT_ID", "HADM_ID"])
            icu_counts = dict(Counter(h for h in icu["HADM_ID"] if not isna(h)))
        except FileNotFoundError:
            icu_counts = {}
        if self.dev:
            df = _dev_cut(df, "SUBJECT_ID")
        _none_column(df, "DOD_HOSP")
        return _build_patients(
            df,
            subject_col="SUBJECT_ID", visit_col="HADM_ID",
            encounter_col="ADMITTIME", discharge_col="DISCHTIME",
            status_col="HOSPITAL_EXPIRE_FLAG", ethnicity_col="ETHNICITY",
            gender_col="GENDER",
            birth_of=lambda d: ts_list(d["DOB"]),
            death_of=lambda d: ts_list(d["DOD_HOSP"]),
            icu_counts=icu_counts,
        )

    def _add_events(self, table: str, vocab: str, code_col: str) -> None:
        df = _read(self.root, table, ["SUBJECT_ID", "HADM_ID", code_col])
        df = df.dropna(["SUBJECT_ID", "HADM_ID", code_col])
        _ingest_events(self.patients, df, table=table, subject_col="SUBJECT_ID",
                       visit_col="HADM_ID", code_col=code_col, vocab=vocab)

    def _parse_diagnoses(self):
        self._add_events("DIAGNOSES_ICD", "ICD9CM", "ICD9_CODE")

    def _parse_procedures(self):
        self._add_events("PROCEDURES_ICD", "ICD9PROC", "ICD9_CODE")

    def _parse_prescriptions(self):
        df = _read(self.root, "PRESCRIPTIONS", ["SUBJECT_ID", "HADM_ID", "NDC"])
        df = df.dropna(["SUBJECT_ID", "HADM_ID", "NDC"])
        _ingest_events(
            self.patients, df, table="PRESCRIPTIONS",
            subject_col="SUBJECT_ID", visit_col="HADM_ID", code_col="NDC",
            vocab="ATC" if self.ndc_to_atc else "NDC",
            code_map=self.ndc_to_atc,
        )

    def _parse_labevents(self):
        """LABEVENTS -> MIMIC3_ITEMID events."""
        self._add_events("LABEVENTS", "MIMIC3_ITEMID", "ITEMID")

    def _parse_icustay_events(self):
        """ICUSTAYS -> icustay events (the per-visit icustays_num comes from
        _parse_basic regardless)."""
        self._add_events("ICUSTAYS", "icustay", "ICUSTAY_ID")


class MIMIC4Dataset:
    """MIMIC-IV CSVs -> {patient_id: Patient} (lowercase schema)."""

    def __init__(
        self,
        root: str | Path,
        tables: tuple[str, ...] = ("diagnoses_icd", "procedures_icd", "prescriptions"),
        *,
        ndc_to_atc: dict[str, str] | None = None,
        dev: bool = False,
    ):
        self.root = Path(root)
        self.dev = dev
        self.ndc_to_atc = ndc_to_atc
        self.patients = self._parse_basic()
        parsers: dict[str, Callable] = {
            "diagnoses_icd": self._parse_diagnoses,
            "procedures_icd": self._parse_procedures,
            "prescriptions": self._parse_prescriptions,
        }
        for t in tables:
            parsers[t]()

    def _parse_basic(self) -> dict[str, Patient]:
        pat = _read(self.root, "patients", ["subject_id"])
        adm = _read(self.root, "admissions", ["subject_id", "hadm_id"])
        df = merge(pat, adm, "subject_id").sort_values(["subject_id", "admittime", "dischtime"])
        if self.dev:
            df = _dev_cut(df, "subject_id")
        _none_column(df, "dod")
        return _build_patients(
            df,
            subject_col="subject_id", visit_col="hadm_id",
            encounter_col="admittime", discharge_col="dischtime",
            status_col="hospital_expire_flag", ethnicity_col="race",
            gender_col="gender",
            # no exact birth datetime in MIMIC-IV: anchor_year - anchor_age
            birth_of=lambda d: ts_list([str(int(y) - int(a)) for y, a in
                                        zip(d["anchor_year"], d["anchor_age"])]),
            death_of=lambda d: ts_list(d["dod"]),
        )

    def _icd_events(self, table: str, suffix: str) -> None:
        df = _read(self.root, table, ["subject_id", "hadm_id", "icd_code"])
        df = df.dropna(["subject_id", "hadm_id", "icd_code", "icd_version"])
        vocab = [f"ICD{int(v)}{suffix}" for v in df["icd_version"]]
        _ingest_events(self.patients, df, table=table, subject_col="subject_id",
                       visit_col="hadm_id", code_col="icd_code", vocab=vocab)

    def _parse_diagnoses(self):
        self._icd_events("diagnoses_icd", "CM")

    def _parse_procedures(self):
        self._icd_events("procedures_icd", "PROC")

    def _parse_prescriptions(self):
        df = _read(self.root, "prescriptions", ["subject_id", "hadm_id", "ndc"])
        df = df.dropna(["subject_id", "hadm_id", "ndc"])
        _ingest_events(
            self.patients, df, table="prescriptions",
            subject_col="subject_id", visit_col="hadm_id", code_col="ndc",
            vocab="ATC" if self.ndc_to_atc else "NDC",
            code_map=self.ndc_to_atc,
        )


class EHRShotDataset:
    """EHRShot CSVs -> {patient_id: Patient} (patients / admissions /
    diagnoses / procedures / prescriptions with start / end times and
    code_val columns)."""

    def __init__(
        self,
        root: str | Path,
        tables: tuple[str, ...] = ("diagnoses", "procedures", "prescriptions"),
        *,
        ndc_to_atc: dict[str, str] | None = None,
        dev: bool = False,
    ):
        self.root = Path(root)
        self.dev = dev
        self.ndc_to_atc = ndc_to_atc
        self.patients = self._parse_basic()
        for t in tables:
            self._parse_codes(t)

    def _parse_basic(self) -> dict[str, Patient]:
        pat = _read(self.root, "patients", ["patient_id"])
        adm = _read(self.root, "admissions", ["patient_id", "visit_id"])
        df = merge(pat, adm, "patient_id").sort_values(["patient_id", "start", "end"])
        if self.dev:
            df = _dev_cut(df, "patient_id")
        _none_column(df, "dod")
        return _build_patients(
            df,
            subject_col="patient_id", visit_col="visit_id",
            encounter_col="start", discharge_col="end",
            status_col=None, ethnicity_col="Race", gender_col="Gender",
            birth_of=lambda d: ts_list(astype_str(d["dob"])),
            death_of=lambda d: ts_list(d["dod"]),
        )

    def _parse_codes(self, table: str):
        df = _read(self.root, table, ["patient_id", "visit_id", "code_val"])
        df = df.dropna(["patient_id", "visit_id", "code_val"])
        df = df.sort_values(["patient_id", "visit_id", "code_val"])
        is_drug = table == "prescriptions"
        if is_drug:
            vocab = "ATC"
        elif "icd_version" in df:
            vocab = astype_str(df["icd_version"])
        else:
            vocab = ""
        _ingest_events(
            self.patients, df, table=table,
            subject_col="patient_id", visit_col="visit_id",
            code_col="code_val", vocab=vocab,
            code_map=self.ndc_to_atc if is_drug else None,
        )
