"""Query code mapping: extracted clinical codes -> MedTok vocabulary ids
(counterpart of ``medtok_tpu/qa/mapping.py``; the ``CodeMapper`` is the
EHR task builders' own, ``medtok_tpu_torch/ehr/tasks.py``).

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

from medtok_tpu_torch.ehr.tasks import CodeMapper

ICD_KEYS = ("ICD-9", "ICD-10")


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
