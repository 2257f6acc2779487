"""EHR featurization: task sample dicts -> static-shape ``EHRBatch`` arrays
(own copy of ``medtok_tpu/ehr/dataset.py``; numpy only).

Flattens the cumulative visit history into one padded code-index sequence
with per-code visit ids, maps -1 (unmapped) to the miss row (= vocab_size),
computes per-visit [years, days, hours] time features within/between visits
(birthdate prepended for the first gap), and dict-encodes gender/ethnicity.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np


class EHRBatch(NamedTuple):
    codes: np.ndarray          # [B, C] int32 vocab row ids (miss = vocab_size)
    visit_ids: np.ndarray      # [B, C] int32 visit index per code
    pad_mask: np.ndarray       # [B, C] bool, True = padding
    gender: np.ndarray         # [B] int32
    ethnicity: np.ndarray      # [B] int32
    time_within: np.ndarray    # [B, V, 3] int32 [years, days, hours]
    time_between: np.ndarray   # [B, V, 3] int32
    label_onehot: np.ndarray   # [B, num_class] float32 (one-hot or multilabel)
    label_raw: np.ndarray      # [B] int32 (or [B, num_class] for multilabel)


def time_format(delta) -> list[int]:
    """timedelta -> [years, remaining_days, hours]; zeros if negative."""
    years = delta.days // 365
    remaining_days = delta.days % 365
    hours = delta.seconds // 3600
    if years < 0 or remaining_days < 0 or hours < 0:
        return [0, 0, 0]
    return [years, remaining_days, hours]


class EHRFeaturizer:
    def __init__(self, *, vocab_size: int, max_visits: int = 100,
                 max_medical_code: int = 2000, max_year: int = 1000):
        self.vocab_size = vocab_size  # miss index == vocab_size
        self.max_visits = max_visits
        self.max_medical_code = max_medical_code
        self.max_year = max_year
        self.gender_dict: dict[Any, int] = {}
        self.ethnicity_dict: dict[Any, int] = {}

    @staticmethod
    def _demo(d, table: dict) -> int:
        if d not in table:
            table[d] = len(table)
        return table[d]

    def featurize(self, sample: dict, label_vec: np.ndarray, raw_label) -> dict:
        V, C = self.max_visits, self.max_medical_code
        conditions = sample["conditions_map"][0]
        procedures = sample["procedures_map"][0]
        drugs = sample["drugs_map"][0]

        codes: list[int] = []
        visit_ids: list[int] = []
        for v_i in range(min(len(conditions), V)):
            node_set = list(conditions[v_i]) + list(procedures[v_i])
            if v_i < len(drugs):
                node_set = node_set + list(drugs[v_i])
            node_set = [self.vocab_size if x == -1 else x for x in node_set]
            codes.extend(node_set)
            visit_ids.extend([v_i] * len(node_set))
        codes = codes[:C]
        visit_ids = visit_ids[:C]

        pad_mask = np.ones(C, bool)
        pad_mask[: len(codes)] = False
        codes = np.asarray(codes + [0] * (C - len(codes)), np.int32)
        visit_ids = np.asarray(visit_ids + [0] * (C - len(visit_ids)), np.int32)

        enc = list(sample["timestamp_encounter"])[:V]
        dis = list(sample["timestamp_discharge"])[:V]
        time_within = np.zeros((V, 3), np.int32)
        time_between = np.zeros((V, 3), np.int32)
        for i in range(len(dis)):
            if dis[i] is None or enc[i] is None:
                continue  # a missing discharge time: zeros, as time_format
                # gives a negative delta
            time_within[i] = time_format(dis[i] - enc[i])
        prev = [sample["birthdate"]] + dis
        for i in range(len(enc)):
            if prev[i] is None or enc[i] is None:
                continue
            time_between[i] = time_format(enc[i] - prev[i])
        # clamp years into the year-embedding table
        time_within[:, 0] = np.clip(time_within[:, 0], 0, self.max_year - 1)
        time_between[:, 0] = np.clip(time_between[:, 0], 0, self.max_year - 1)

        return {
            "codes": codes,
            "visit_ids": visit_ids,
            "pad_mask": pad_mask,
            "gender": self._demo(sample["gender"], self.gender_dict),
            "ethnicity": self._demo(sample["ethnicity"], self.ethnicity_dict),
            "time_within": time_within,
            "time_between": time_between,
            "label_onehot": label_vec.astype(np.float32),
            "label_raw": raw_label,
        }

    def collate(self, feats: Sequence[dict]) -> EHRBatch:
        def stack(key):
            return np.stack([f[key] for f in feats])

        return EHRBatch(
            codes=stack("codes"),
            visit_ids=stack("visit_ids"),
            pad_mask=stack("pad_mask"),
            gender=np.asarray([f["gender"] for f in feats], np.int32),
            ethnicity=np.asarray([f["ethnicity"] for f in feats], np.int32),
            time_within=stack("time_within"),
            time_between=stack("time_between"),
            label_onehot=stack("label_onehot"),
            label_raw=np.asarray([f["label_raw"] for f in feats]),
        )


def make_label_vec(raw_label, num_class: int, task: str) -> np.ndarray:
    if task in ("phenotype", "drugrec"):
        return np.asarray(raw_label, np.float32)  # already a multilabel row
    v = np.zeros(num_class, np.float32)
    v[int(raw_label)] = 1.0
    return v
