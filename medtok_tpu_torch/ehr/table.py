"""A column table without pandas: the reads and frame operations the EHR
parsers, the code maps and the code mapper need, with the results pandas
gives the JAX package, so the EHR path runs where pandas is missing.

What is reproduced, and how:
- ``read_csv(path, str_columns)``: ``pd.read_csv(path, dtype={c: str})``.
  ``.csv`` or ``.csv.gz`` (by suffix), a UTF-8 byte-order mark dropped,
  blank lines skipped, short rows filled with NaN. A field equal to one of
  pandas' default NA strings (``NA_STRINGS``) is NaN, in the string columns
  too. The other columns are typed as pandas infers them: int when every
  field is an integer, float when every field is a number or NA, bool when
  every field is True / False (NaN kept beside them), else strings.
- NaN is a float. In a string column every NaN is the one object
  ``np.nan``, as pandas 3's string columns give it back (the featurizer keys
  its demographic dictionaries on these values, so identity counts); in a
  float column each NaN is a float of its own, as ``tolist`` gives them.
- ``merge``: ``pd.merge(how="inner")``, the left frame's row order, each
  left row's matches in the right frame's order, NaN keys matching NaN,
  other columns named in both frames suffixed ``_x`` / ``_y``.
- ``drop_duplicates`` keeps first occurrences (NaN equal to NaN);
  ``sort_values`` is stable, by each column's values (strings by code
  point), NaN last.
- ``to_datetime``: one value of ``pd.to_datetime(format="mixed",
  errors="coerce")`` under pandas 3 (microsecond resolution, so every year
  from 1 to 9999 parses): ISO 8601 dates and date-times (a bare year is its
  1 January), else pandas' test of whether a string looks like a date,
  then ``dateutil`` (an ImportError where it is not installed and such a
  string comes); what does not parse is None.
"""

from __future__ import annotations

import csv
import gzip
import io
import re
from datetime import datetime
from pathlib import Path
from typing import Any, Iterable, Sequence

import numpy as np

NAN = np.nan

# pandas._libs.parsers.STR_NA_VALUES (pandas 3.0)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?)",
                    re.IGNORECASE)


def isna(v: Any) -> bool:
    return v is None or (isinstance(v, float) and v != v)


class Table:
    """Named columns of equal length (Python lists)."""

    def __init__(self, columns: dict[str, list]):
        self.columns = columns
        lengths = {len(c) for c in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        self.n = lengths.pop() if lengths else 0

    def __len__(self) -> int:
        return self.n

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def __setitem__(self, name: str, values: list) -> None:
        if len(values) != self.n:
            raise ValueError(f"column {name!r} has {len(values)} rows, the table {self.n}")
        self.columns[name] = values

    def take(self, rows: Sequence[int]) -> "Table":
        return Table({k: [c[i] for i in rows] for k, c in self.columns.items()})

    def _keys(self, names: Sequence[str]) -> list[tuple]:
        cols = [[na_key(v) for v in self.columns[n]] for n in names]
        return list(zip(*cols)) if cols else [()] * self.n

    def dropna(self, subset: Sequence[str]) -> "Table":
        cols = [self.columns[n] for n in subset]
        return self.take([i for i in range(self.n) if not any(isna(c[i]) for c in cols)])

    def drop_duplicates(self, subset: Sequence[str]) -> "Table":
        seen: set = set()
        keep = []
        for i, k in enumerate(self._keys(subset)):
            if k not in seen:
                seen.add(k)
                keep.append(i)
        return self.take(keep)

    def sort_values(self, by: Sequence[str]) -> "Table":
        """Stable sort, NaN last in each column."""
        cols = [self.columns[n] for n in by]
        order = sorted(range(self.n), key=lambda i: tuple(
            (1, 0) if isna(c[i]) else (0, c[i]) for c in cols))
        return self.take(order)

    def isin(self, name: str, values: Iterable) -> "Table":
        keys = {na_key(v) for v in values}
        col = self.columns[name]
        return self.take([i for i in range(self.n) if na_key(col[i]) in keys])


class _NaKey:
    """The hashable stand-in of NaN in keys: equal to itself only."""

    def __repr__(self) -> str:
        return "NaN"


_NA_KEY = _NaKey()


def na_key(v):
    return _NA_KEY if isna(v) else v


def merge(left: Table, right: Table, on: str) -> Table:
    """``pd.merge(left, right, on=on, how="inner")``."""
    matches: dict = {}
    for j, k in enumerate(right[on]):
        matches.setdefault(na_key(k), []).append(j)
    li, ri = [], []
    for i, k in enumerate(left[on]):
        for j in matches.get(na_key(k), ()):
            li.append(i)
            ri.append(j)
    both = (set(left.columns) & set(right.columns)) - {on}
    out: dict[str, list] = {}
    for name, col in left.columns.items():
        out[name + "_x" if name in both else name] = [col[i] for i in li]
    for name, col in right.columns.items():
        if name != on:
            out[name + "_y" if name in both else name] = [col[j] for j in ri]
    return Table(out)


def _open_text(path: Path):
    raw = gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")
    return io.TextIOWrapper(raw, encoding="utf-8-sig", newline="")


def _infer(values: list[str]) -> list:
    """One column's fields as pandas' C parser types them."""
    present = [v.strip() for v in values if v not in NA_STRINGS]
    if not present:
        return [float("nan") for _ in values]
    if all(_INT.fullmatch(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [float("nan") if v in NA_STRINGS else float(int(v)) for v in values]
    if all(_FLOAT.fullmatch(v) for v in present):
        return [float("nan") if v in NA_STRINGS else float(v) for v in values]
    if all(v in _TRUE or v in _FALSE for v in present):
        return [NAN if v in NA_STRINGS else v in _TRUE for v in values]
    return [NAN if v in NA_STRINGS else v for v in values]


def read_csv(path: str | Path, str_columns: Iterable[str] | bool = (), *,
             sep: str = ",") -> Table:
    """``pd.read_csv(path, sep=sep, dtype={c: str for c in str_columns})``;
    ``str_columns=True`` is ``dtype=str``."""
    path = Path(path)
    with _open_text(path) as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader, None)
        if header is None:
            raise ValueError(f"{path}: no header line")
        width = len(header)
        fields: list[list[str]] = [[] for _ in header]
        for row in reader:
            if not row or (len(row) == 1 and not row[0].strip()):
                continue  # a blank line
            if len(row) > width:
                raise ValueError(f"{path}: line {reader.line_num} has {len(row)} fields, "
                                 f"the header {width}")
            row = row + [""] * (width - len(row))
            for col, v in zip(fields, row):
                col.append(v)
    if str_columns is True:
        str_columns = header
    str_columns = set(str_columns)
    columns = {}
    for name, values in zip(header, fields):
        if name in str_columns:
            columns[name] = [NAN if v in NA_STRINGS else v for v in values]
        else:
            columns[name] = _infer(values)
    return Table(columns)


def astype_str(values: list) -> list:
    """``Series.astype(str)`` under pandas 3: NaN stays NaN."""
    return [v if isna(v) else str(v) for v in values]


# ------------------------------------------------------------- datetimes ---

_NAT_STRINGS = frozenset({"NaT", "nat", "NAT", "nan", "NaN", "NAN"})
_ISO = re.compile(
    r"(\d{4})(?:(?:-(\d{1,2})(?:-(\d{1,2}))?)|(\d{2})(\d{2}))?"
    r"(?:[T ](\d{2})(?::?(\d{2})(?::?(\d{2})(?:[.,](\d{1,9}))?)?)?)?")
_NOT_DATELIKE = frozenset({"a", "A", "m", "M", "p", "P", "t", "T"})


def _looks_like_datetime(s: str) -> bool:
    """pandas' ``does_string_look_like_datetime``: a number below 1000
    is no date."""
    if s[0] == "0":
        return True
    if s in _NOT_DATELIKE:
        return False
    try:
        return float(s) >= 1000
    except ValueError:
        return True


def _dateutil(s: str) -> datetime | None:
    """A non-ISO string as pandas would parse it, through dateutil. Where
    dateutil is not installed this raises, rather than read the date as
    NaT where pandas would parse it."""
    try:
        from dateutil.parser import parse
    except ImportError:
        raise ImportError(f"parsing the date {s!r} (not ISO 8601) needs python-dateutil, "
                          "which is not installed") from None
    try:
        return parse(s, default=datetime(1, 1, 1))
    except (ValueError, OverflowError):
        return None


def to_datetime(v: Any) -> datetime | None:
    """One string (or NaN / None) of ``pd.to_datetime(column,
    format="mixed", errors="coerce")`` as a ``datetime``, None for NaT. A
    number is read as its string (pandas would read nanoseconds since 1970;
    the date columns of these tables hold strings)."""
    if isna(v):
        return None
    s = str(v).strip()
    if not s or s in _NAT_STRINGS:
        return None
    m = _ISO.fullmatch(s)
    if m:
        year, mon, day, bmon, bday, hh, mm, ss, frac = m.groups()
        try:
            return datetime(int(year), int(mon or bmon or 1), int(day or bday or 1),
                            int(hh or 0), int(mm or 0), int(ss or 0),
                            int((frac or "0")[:6].ljust(6, "0")))
        except ValueError:
            return None
    if not _looks_like_datetime(s):
        return None
    return _dateutil(s)


def ts_list(values: list) -> list[datetime | None]:
    return [to_datetime(v) for v in values]
