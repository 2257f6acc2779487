"""Medical-QA dataset loaders (own copy of ``medtok_tpu/qa/datasets.py``).

- ``load_qa_rows``: the pre-mapped training / eval JSON, rows
  {"input": [question_with_options, answer letter], "medical_codes":
  [vocab ids]}, with its schema checked.
- ``AfrimedLoader``: MCQ / SAQ question dicts from AfrimedQA-v2 records,
  given as raw records (dicts with question_clean / answer_options /
  correct_answer / question_type / tier) or as a cached JSON.
- ``format_mcq``: the " A: ..." option formatting of those datasets.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable

OPTION_PREFIXES = [" A: ", " B: ", " C: ", " D: ", " E: ", " F: "]


def load_qa_rows(path: str | Path) -> list[dict]:
    """Pre-mapped QA rows; validates the schema."""
    rows = json.loads(Path(path).read_text())
    if not isinstance(rows, list) or not rows:
        raise ValueError(f"{path}: expected non-empty list")
    for r in rows[:5]:
        if "input" not in r or "medical_codes" not in r or len(r["input"]) < 2:
            raise ValueError(f"{path}: bad row schema: {r}")
    return rows


def format_mcq(question: str, choices: list[str]) -> str:
    """question + ' A:  x\\n B:  y\\n...' (extract_diseases.py:87-91)."""
    text = question.strip() + "\n"
    for j, c in enumerate(choices):
        text += f"{OPTION_PREFIXES[j]} {c}\n"
    return text


class AfrimedLoader:
    """MCQ/SAQ benchmark dicts from AfrimedQA-v2 records.

    data: 'AfrimedQA-MCQ' | 'AfrimedQA-SAQ' (or raw 'mcq_expert'/'saq_expert').
    records: iterable of AfrimedQA rows; cache_dir: where the processed
    ``AfrimedQA_<name>.json`` lives / is written (the reference's caching
    behavior, extract_diseases.py:66-71, 108-110).
    """

    def __init__(
        self,
        data: str = "AfrimedQA-MCQ",
        *,
        records: Iterable[dict] | None = None,
        cache_dir: str | Path | None = None,
    ):
        name_map = {
            "AfrimedQA-MCQ": "mcq_expert",
            "AfrimedQA-SAQ": "saq_expert",
            "mcq_expert": "mcq_expert",
            "saq_expert": "saq_expert",
        }
        if data not in name_map:
            raise KeyError(f"{data} not supported")
        self.data = name_map[data]

        cache = (
            Path(cache_dir) / f"AfrimedQA_{self.data}.json"
            if cache_dir is not None else None
        )
        if cache is not None and cache.exists():
            benchmark = json.loads(cache.read_text())
        elif records is not None:
            benchmark = self._process(records)
            if cache is not None:
                cache.write_text(json.dumps(benchmark, indent=2))
        else:
            raise FileNotFoundError(
                "no cached AfrimedQA json and no records provided "
                "(offline environment: pass records= or cache_dir=)"
            )
        self.dataset: dict[str, dict] = benchmark[self.data]
        self.index = sorted(self.dataset.keys())

    def _process(self, records: Iterable[dict]) -> dict:
        out: dict[str, dict] = {"mcq_expert": {}, "saq_expert": {}}
        for d in records:
            if d.get("tier") != "expert":
                continue
            if d.get("question_type") == "mcq":
                opts = d["answer_options"]
                if isinstance(opts, str):
                    opts = json.loads(opts)
                choices = list(opts.values())
                text = format_mcq(d["question_clean"], choices)
                label_index = int(d["correct_answer"][6]) - 1
                idx = str(len(out["mcq_expert"]))
                out["mcq_expert"][idx] = {
                    "query": text,
                    "answer": chr(ord("A") + label_index),
                    "answer_index": label_index,
                    "answer_content": choices[label_index],
                }
            elif d.get("question_type") == "saq":
                text = d["question_clean"].strip() + "\n"
                answer = (
                    d["answer_rationale"].strip().replace("\n", " ").replace("\r", "")
                )
                idx = str(len(out["saq_expert"]))
                out["saq_expert"][idx] = {
                    "query": text, "answer": answer,
                    "answer_index": None, "answer_content": None,
                }
        return out

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key: int) -> dict[str, Any]:
        d = self.dataset[self.index[key]]
        answer = d["answer"].strip()
        label = answer if self.data == "saq_expert" else ord(answer) - ord("A")
        return {"text": d["query"], "answer": answer, "answer_index": label}
