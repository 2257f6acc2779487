"""Clinical code-system mappings (NDC -> ATC-5 etc.; own copy of
``medtok_tpu/ehr/code_maps.py``, read without pandas).

A user-provided crosswalk file feeds the parsers' ``ndc_to_atc`` argument.
Accepted formats:
- CSV with columns (ndc, atc) — extra columns ignored, case-insensitive
- a two-column CSV / TSV (its first line is read as the header, as pandas
  reads it)
- JSON object {ndc: atc}
"""

from __future__ import annotations

import json
from pathlib import Path

from medtok_tpu_torch.ehr.table import read_csv


def load_code_map(path: str | Path) -> dict[str, str]:
    p = Path(path)
    if p.suffix == ".json":
        return {str(k): str(v) for k, v in json.loads(p.read_text()).items()}

    sep = "\t" if p.suffix in (".tsv", ".txt") else ","
    df = read_csv(p, True, sep=sep)
    names = list(df.columns)
    cols = {c.lower(): c for c in names}
    if "ndc" in cols and "atc" in cols:
        src, dst = cols["ndc"], cols["atc"]
    elif len(names) >= 2:
        src, dst = names[0], names[1]
    else:
        raise ValueError(f"{path}: need (ndc, atc) columns or 2 columns")
    df = df.dropna([src, dst])
    return dict(zip(df[src], df[dst]))


def to_atc_level(code: str, level: int = 5) -> str:
    """Truncate an ATC code to a level boundary (level 5 = 7 chars, 4 = 5,
    3 = 4, 2 = 3, 1 = 1)."""
    lengths = {1: 1, 2: 3, 3: 4, 4: 5, 5: 7}
    return code[: lengths[level]]
