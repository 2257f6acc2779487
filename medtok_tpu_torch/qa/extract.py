"""Clinical-entity code extraction from QA questions through an LLM client
(own copy of ``medtok_tpu/qa/extract.py``): a prompt asking for a JSON
object of Diseases / Medications / Procedures with ICD-10 / ICD-9 / ATC /
NDC codes, the parsing of the first JSON object in the reply, retries on a
malformed one, and ``query_icd_codes_<dataset>.json``. The client is any
``client(prompt) -> str`` callable.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable

EXTRACTION_PROMPT = """You are a clinical coding assistant. Given a medical \
exam question, identify every disease, medication, and procedure it mentions \
and provide standard codes for each. Respond with ONLY a JSON object of the \
form:
{{"Diseases": {{"ICD-10": [...], "ICD-9": [...]}}, \
"Medications": {{"ATC": [...], "NDC": [...]}}, \
"Procedures": {{"ICD-10": [...], "ICD-9": [...]}}}}
Use empty lists when nothing applies. The question is:
{question}"""


def parse_extraction(text: str) -> dict[str, Any]:
    """Extract the first JSON object from a model response; raise ValueError
    when unparseable (caller retries, extract_diseases.py:168-186)."""
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if not m:
        raise ValueError("no JSON object in response")
    return json.loads(m.group(0))


def flatten_codes(extraction: dict[str, Any]) -> dict[str, list[str]]:
    """{'Diseases': {'ICD-10': [...]}, ...} -> {'ICD-10': [...], ...} merged
    across entity kinds (the shape map_query_id consumes)."""
    out: dict[str, list[str]] = {}
    for kinds in extraction.values():
        if not isinstance(kinds, dict):
            continue
        for vocab, codes in kinds.items():
            if codes:
                out.setdefault(vocab, []).extend(str(c) for c in codes)
    return out


def extract_codes(
    question: str,
    client: Callable[[str], str],
    *,
    max_retries: int = 3,
) -> dict[str, list[str]]:
    prompt = EXTRACTION_PROMPT.format(question=question)
    for attempt in range(max_retries):
        try:
            return flatten_codes(parse_extraction(client(prompt)))
        except (ValueError, json.JSONDecodeError):
            if attempt == max_retries - 1:
                return {}
    return {}


def extract_dataset(
    questions: list[str],
    client: Callable[[str], str],
    out_path: str | Path | None = None,
) -> dict[str, dict[str, list[str]]]:
    """All questions -> {idx: code_dict}; optionally saved as
    query_icd_codes_<dataset>.json (extract_diseases.py:246-247)."""
    result = {str(i): extract_codes(q, client) for i, q in enumerate(questions)}
    if out_path is not None:
        Path(out_path).write_text(json.dumps(result))
    return result
