"""Query code mapping: extracted clinical codes -> MedTok vocabulary ids
(counterpart of ``medtok_tpu/qa/mapping.py``, with its own copy of the
``CodeMapper`` of ``medtok_tpu/ehr/tasks.py``).

A code is looked up dot-stripped (ICD codes), with a fallback to the first
vocabulary entry whose "A-B" string range holds it; an empty extraction
maps to the null id ``len(vocab)``. The training rows are
``{"input": [query, answer], "medical_codes": [ids]}``. The query's CODE
is range-checked (not the whole query dict).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from medtok_tpu_torch.data.dataset import read_jsonl

ICD_KEYS = ("ICD-9", "ICD-10")


def read_med_codes(path: str | Path) -> list[str]:
    """The ``med_code`` column of a ``.jsonl`` vocabulary or of an
    all_codes_mappings ``.parquet`` (the latter needs pandas and pyarrow)."""
    suffix = Path(path).suffix
    if suffix == ".jsonl":
        return [str(c) for c in read_jsonl(path)["med_code"]]
    if suffix == ".parquet":
        import pandas as pd

        return pd.read_parquet(path)["med_code"].astype(str).tolist()
    raise ValueError(f"{path}: the code vocabulary must be a .parquet or a .jsonl file")


class CodeMapper:
    """code string -> row index in the MedTok vocabulary (dots stripped),
    with the string-range fallback and -1 for unmapped."""

    def __init__(self, med_codes_pkg_map_path: str | Path):
        codes = [c.replace(".", "") for c in read_med_codes(med_codes_pkg_map_path)]
        self.num_codes = len(codes)
        self.code_to_idx: dict[str, int] = {}
        for idx, c in enumerate(codes):
            self.code_to_idx.setdefault(c, idx)
        self.ranges: dict[str, int] = {
            c: i for i, c in enumerate(codes) if "-" in c
        }
        self._cache: dict[str, int] = {}

    def __len__(self) -> int:
        return self.num_codes

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


class QueryCodeMapper:
    def __init__(self, mapper: CodeMapper):
        self.mapper = mapper
        self.null_id = len(mapper)

    def map_code_dict(self, code_dict: dict[str, Any]) -> list[int]:
        """{'ICD-10': [...], 'ATC': [...], ...} -> vocab ids; [] -> [null]."""
        if not code_dict:
            return [self.null_id]
        out: list[int] = []
        for key, codes in code_dict.items():
            if not codes:
                continue
            for c in codes:
                if c is None:
                    continue
                c = str(c)
                if key in ICD_KEYS:
                    c = c.replace(".", "")
                idx = self.mapper.map(c)
                if idx >= 0:
                    out.append(idx)
        return out or [self.null_id]

    def build_dataset(
        self,
        queries: list[tuple[str, str]],
        code_dicts: dict[str, dict] | list[dict],
        out_path: str | Path | None = None,
    ) -> list[dict]:
        """[(question, answer)] + per-query code dicts -> training rows."""
        rows = []
        for i, (q, a) in enumerate(queries):
            cd = code_dicts[str(i)] if isinstance(code_dicts, dict) else code_dicts[i]
            rows.append({"input": [q, a], "medical_codes": self.map_code_dict(cd)})
        if out_path is not None:
            Path(out_path).write_text(json.dumps(rows))
        return rows
