"""EHR task builders: raw Patients -> per-patient sample dicts (counterpart
of ``medtok_tpu/ehr/tasks.py``).

Every raw code maps to its row in the MedTok vocabulary (dots stripped),
with an ICD-range fallback and -1 for unmapped; each task builds samples
with the cumulative visit history and time-sorted stamps.

Tasks (label semantics):
- readmission: next visit within 15 days
- mortality:   next-visit HOSPITAL_EXPIRE_FLAG; EHRShot: one sample per
               patient labeled by death_datetime
- lenofstay:   10-class bucketing of discharge-encounter days; EHRShot:
               2-class (<= 7 days)
- phenotype:   labels of a phenotype index (label -> KG node) whose node a
               visit's conditions reach; visits with more than one ICU stay
               skipped
- drugrec:     5 fixed ATC candidates present in the current visit
- new_disease: AMI onset within 365 days

A range entry of the vocabulary is any code containing '-', and each code
maps to exactly one index (or -1). Samples hold only builtins and
datetimes, so a pickle cache either package wrote reads in the other.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import numpy as np

from medtok_tpu_torch.data.dataset import read_vocab_columns
from medtok_tpu_torch.ehr.data import Patient

# AMI ICD-9/10 codes
AMI_CODES = [
    "4100", "4101", "4102", "4103", "4104", "4105", "4106", "4107", "4108",
    "4109", "I210", "I211", "I213", "I214", "I219", "I22x", "41000", "41001",
    "41010", "41011", "41020", "41021", "41030", "41031", "41040", "41041",
    "41050", "41051", "41060", "41061", "41070", "41071", "41080", "41081",
    "41090", "41091",
]
# drug-recommendation ATC candidates
DRUG_CANDIDATES = ["J01XA01", "J01MA12", "B01AB01", "C07AB02", "C10AA05"]


class CodeMapper:
    """code string -> row index in the MedTok vocab (dots stripped), with
    string-range fallback and -1 for unmapped."""

    def __init__(self, med_codes_pkg_map_path: str | Path):
        cols = read_vocab_columns(med_codes_pkg_map_path)
        self.med_codes = [str(c) for c in cols["med_code"]]
        self.pkg_index_lists = cols["pkg_index_list"]
        codes = [c.replace(".", "") for c in self.med_codes]
        self.code_to_idx: dict[str, int] = {}
        for idx, c in enumerate(codes):
            self.code_to_idx.setdefault(c, idx)
        self.ranges: dict[str, int] = {c: i for i, c in enumerate(codes) if "-" in c}
        self._cache: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.med_codes)

    def map(self, code: str) -> int:
        code = str(code)
        if code in self._cache:
            return self._cache[code]
        idx = self.code_to_idx.get(code)
        if idx is None:
            idx = -1
            for rng, v in self.ranges.items():
                if self._in_range(code, rng):
                    idx = v
                    break
        self._cache[code] = idx
        return idx

    @staticmethod
    def _in_range(value: str, range_string: str) -> bool:
        parts = range_string.split("-")[:2]
        if len(parts) < 2:
            return False
        left, right = parts
        return left <= value <= right

    def pkg_nodes(self, idx: int) -> list[int]:
        return list(self.pkg_index_lists[idx])


class PatientEHRTasks:
    """Builds task samples from parsed patients. ``dataset`` in
    {'MIMIC_III', 'MIMIC_IV', 'EHRShot'} sets the table names and the task
    variants."""

    def __init__(
        self,
        patients: dict[str, Patient],
        mapper: CodeMapper,
        *,
        dataset: str = "MIMIC_III",
        visit_num_th: int = 2,
        phenotype_index: dict[int, int] | str | Path | None = None,
        cache_path: str | Path | None = None,
    ):
        self.patients = patients
        self.mapper = mapper
        self.dataset = dataset
        self.visit_num_th = visit_num_th
        if isinstance(phenotype_index, (str, Path)):
            with open(phenotype_index, "rb") as f:
                phenotype_index = pickle.load(f)
        self.phenotype_index = phenotype_index
        self.cache_path = Path(cache_path) if cache_path else None

    def _tables(self) -> tuple[str, str, str]:
        if self.dataset == "MIMIC_III":
            return "DIAGNOSES_ICD", "PROCEDURES_ICD", "PRESCRIPTIONS"
        if self.dataset == "MIMIC_IV":
            return "diagnoses_icd", "procedures_icd", "prescriptions"
        return "diagnoses", "procedures", "prescriptions"

    def _visit_codes(self, visit) -> tuple[list[str], list[str], list[str]] | None:
        ct, pt, dt = self._tables()
        conditions = visit.get_code_list(table=ct)
        if self.dataset in ("MIMIC_III", "MIMIC_IV"):
            conditions = [c.replace(".", "") for c in conditions]
        procedures = visit.get_code_list(table=pt)
        drugs = visit.get_code_list(table=dt)
        # visits missing any of the three code kinds are left out
        if len(conditions) * len(procedures) * len(drugs) == 0:
            return None
        return conditions, procedures, drugs

    def _sorted_visits(self, patient: Patient, *,
                       skip_multi_icu: bool = False) -> list[dict[str, Any]]:
        rows = []
        for visit in patient:
            if skip_multi_icu and visit.attr_dict.get("icustays_num", 1) > 1:
                continue
            codes = self._visit_codes(visit)
            if codes is None:
                continue
            conditions, procedures, drugs = codes
            rows.append({
                "encounter": visit.encounter_time,
                "discharge": visit.discharge_time,
                "status": visit.discharge_status,
                "conditions": sorted(set(self.mapper.map(c) for c in conditions)),
                "procedures": sorted(set(self.mapper.map(p) for p in procedures)),
                "drugs": sorted(set(self.mapper.map(d) for d in drugs)),
            })
        rows.sort(key=lambda r: r["encounter"])
        return rows

    def _sample(self, patient, rows, upto, label):
        """History through visit index ``upto`` (inclusive) + label."""
        return {
            "patient_id": patient.patient_id,
            "birthdate": patient.birth_datetime,
            "deathdate": patient.death_datetime,
            "gender": patient.gender,
            "ethnicity": patient.ethnicity,
            "conditions_map": [[r["conditions"] for r in rows[:upto + 1]]],
            "procedures_map": [[r["procedures"] for r in rows[:upto + 1]]],
            "drugs_map": [[r["drugs"] for r in rows[:upto + 1]]],
            "label": label,
            "timestamp_encounter": [r["encounter"] for r in rows[:upto + 1]],
            "timestamp_discharge": [r["discharge"] for r in rows[:upto + 1]],
        }

    # ---- task builders ----

    def readmission(self, patient: Patient, time_window: int = 15):
        rows = self._sorted_visits(patient)
        if len(rows) < 2:
            return None
        samples = []
        for i in range(len(rows) - 1):
            gap = (rows[i + 1]["encounter"] - rows[i]["encounter"]).days
            samples.append(self._sample(patient, rows, i, int(gap <= time_window)))
        return samples

    def mortality(self, patient: Patient):
        if len(patient) < self.visit_num_th:
            return None
        rows = self._sorted_visits(patient)
        if self.dataset == "EHRShot":
            if not rows:
                return None
            label = int(patient.death_datetime is not None)
            return [self._sample(patient, rows, len(rows) - 1, label)]
        if len(rows) < 2:
            return None
        samples = []
        for i in range(len(rows) - 1):
            status = rows[i + 1]["status"]
            label = int(status) if status in (0, 1) else 0
            samples.append(self._sample(patient, rows, i, label))
        return samples

    def lenofstay(self, patient: Patient):
        rows = self._sorted_visits(patient)
        if len(rows) < 1:
            return None

        def categorize(days):
            if self.dataset == "EHRShot":
                return 0 if 0 < days <= 7 else 1
            if days < 1:
                return 0
            if 1 <= days <= 7:
                return int(days)
            if 8 <= days <= 14:
                return 8
            return 9

        samples = []
        for i in range(len(rows) - 1):
            if rows[i]["discharge"] is None:
                continue  # no discharge time: no stay length
            days = (rows[i]["discharge"] - rows[i]["encounter"]).days
            samples.append(self._sample(patient, rows, i, categorize(days)))
        return samples or None

    def phenotype(self, patient: Patient):
        assert self.phenotype_index is not None, "phenotype_index required"
        if len(patient) < self.visit_num_th:
            return None
        rows = self._sorted_visits(patient, skip_multi_icu=True)
        if len(rows) < 2:
            return None
        labels_per_visit = []
        for r in rows:
            nodes: set[int] = set()
            for c_idx in r["conditions"]:
                if c_idx >= 0:
                    nodes.update(self.mapper.pkg_nodes(c_idx))
            p_labels = [l for l, node in self.phenotype_index.items() if node in nodes]
            if not p_labels:
                return None  # a visit without a label drops the patient
            labels_per_visit.append(p_labels)
        return [self._sample(patient, rows, i, labels_per_visit[i])
                for i in range(len(rows) - 1)]

    def drugrec(self, patient: Patient):
        if len(patient) < self.visit_num_th:
            return None
        rows = self._sorted_visits(patient, skip_multi_icu=True)
        if len(rows) < 2:
            return None
        cand_idx = [self.mapper.map(d) for d in DRUG_CANDIDATES]
        samples = []
        for i in range(len(rows)):
            # unmapped candidates (-1) must not match the -1s of unmapped drugs
            label = [k for k, d in enumerate(cand_idx) if d >= 0 and d in rows[i]["drugs"]]
            if not label:
                continue
            s = self._sample(patient, rows, i, label)
            # the drug history leaves out the current visit
            s["drugs_map"] = [[r["drugs"] for r in rows[:i]]]
            samples.append(s)
        return samples or None

    def new_disease(self, patient: Patient, window_days: int = 365):
        rows = self._sorted_visits(patient)
        if len(rows) < 2:
            return None
        cand = {self.mapper.map(c) for c in AMI_CODES} - {-1}
        samples = []
        for i in range(len(rows) - 1):
            nxt = (set(rows[i + 1]["conditions"]) | set(rows[i + 1]["procedures"])
                   | set(rows[i + 1]["drugs"]))
            gap = (rows[i + 1]["encounter"] - rows[i]["encounter"]).days
            label = int(bool(cand & nxt) and gap <= window_days)
            samples.append(self._sample(patient, rows, i, label))
        return samples

    def build(self, task: str) -> list[list[dict[str, Any]]]:
        """All patients -> list of per-patient sample lists, with an
        optional pickle cache."""
        if self.cache_path is not None and self.cache_path.exists():
            with open(self.cache_path, "rb") as f:
                return pickle.load(f)
        fn = {
            "readmission": self.readmission,
            "mortality": self.mortality,
            "lenofstay": self.lenofstay,
            "phenotype": self.phenotype,
            "drugrec": self.drugrec,
            "new_disease": self.new_disease,
        }[task]
        out = []
        for patient in self.patients.values():
            s = fn(patient)
            if s:
                out.append(s)
        if self.cache_path is not None:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.cache_path, "wb") as f:
                pickle.dump(out, f)
        return out


def build_labels(dataset: list[list[dict]], task: str) -> tuple[np.ndarray, int]:
    """Label matrix + num_class with the >=3-positive column filter for
    phenotype / drugrec, from the FIRST sample of each patient."""
    if task in ("phenotype", "drugrec"):
        width = 24 if task == "phenotype" else 5
        raw = np.asarray([[1 if j in d[0]["label"] else 0 for j in range(width)]
                          for d in dataset])
        keep = (raw != 0).sum(axis=0) >= 3
        labels = raw[:, keep]
        return labels, labels.shape[-1]
    labels = np.asarray([int(d[0]["label"]) for d in dataset])
    return labels, int(labels.max()) + 1
