"""Sequence packing for the text-encoder sweep (counterpart of
``medtok_tpu/data/packing.py::pack_store_meta`` / ``take_group`` and
``medtok_tpu/data/compact.py::derive_packed_meta``).

Length-sorted descriptions fill fixed [R, P] BERT rows greedily; each code is
described by its first flat slot (``flat_base``) and its token count. The
segment ids, within-segment positions and per-code gather map are derived
from those two vectors on the device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def pack_store_meta(
    arena: np.ndarray,
    start: np.ndarray,
    length: np.ndarray,
    rows_idx: np.ndarray,
    *,
    row_len: int = 128,
    num_rows: int | None = None,
):
    """Pack descriptions straight out of an (arena, start, length) text store
    into [R, row_len] rows with a greedy sequential fill.

    Returns (input_ids [R, P] int32, flat_base [B] int32, lens [B] int32)."""
    rows_idx = np.asarray(rows_idx, np.int64)
    B = len(rows_idx)
    lens = length[rows_idx].astype(np.int64)
    if B and lens.max(initial=0) > row_len:
        raise ValueError(f"description longer than row_len={row_len}")
    cum = np.zeros(B + 1, np.int64)
    np.cumsum(lens, out=cum[1:])

    # items i..j-1 share a row where cum[j]-cum[i] <= row_len, j maximal
    flat_base = np.empty(B, np.int64)
    i = 0
    row = 0
    while i < B:
        j = int(np.searchsorted(cum, cum[i] + row_len, side="right")) - 1
        flat_base[i:j] = row * row_len + (cum[i:j] - cum[i])
        row += 1
        i = j
    R = num_rows if num_rows is not None else row
    if row > R:
        raise ValueError(f"packing needs {row} rows > num_rows={R}")

    input_ids = np.zeros(R * row_len, np.int32)
    if B:
        total = int(cum[-1])
        code_of = np.repeat(np.arange(B), lens)
        within = np.arange(total) - cum[code_of]
        src = start[rows_idx][code_of] + within
        input_ids[flat_base[code_of] + within] = arena[src]
    return (
        input_ids.reshape(R, row_len),
        flat_base.astype(np.int32),
        lens.astype(np.int32),
    )


def take_group(
    lens: np.ndarray, order: np.ndarray, start: int,
    *, row_len: int, num_rows: int, max_codes: int,
) -> int:
    """End index (into ``order``) of the largest group starting at ``start``
    whose texts fit ``num_rows`` rows of ``row_len`` under greedy fill."""
    rows_used, fill, j = 1, 0, start
    while j < len(order) and j - start < max_codes:
        n = int(lens[order[j]])
        if fill + n > row_len:
            if rows_used == num_rows:
                break
            rows_used, fill = rows_used + 1, 0
        fill += n
        j += 1
    return j


def iter_groups(
    lens: np.ndarray, *, row_len: int, num_rows: int, max_codes: int,
) -> Iterator[np.ndarray]:
    """Code groups of the packed sweep in length order: each fits one
    [num_rows, row_len] packed batch and holds at most ``max_codes`` codes."""
    order = np.argsort(lens, kind="stable")
    i = 0
    while i < len(order):
        j = take_group(lens, order, i, row_len=row_len, num_rows=num_rows,
                       max_codes=max_codes)
        yield order[i:j]
        i = j


def derive_packed_meta(flat_base: torch.Tensor, tlens: torch.Tensor, *,
                       num_rows: int, row_len: int, lmax: int):
    """Rebuild the packed-text arrays from the per-code vectors.

    flat_base [C] int32 (non-decreasing: codes pack in order) and tlens [C]
    int32. Returns (seg_ids [R, P], pos_ids [R, P], gather_idx [C, lmax],
    text_mask [C, lmax]); segment id c + 1 marks code c, 0 marks padding.
    """
    dev = flat_base.device
    f = torch.arange(num_rows * row_len, dtype=torch.int32, device=dev)
    c = torch.searchsorted(flat_base, f, right=True).to(torch.int64) - 1
    c = c.clamp(0, flat_base.shape[0] - 1)
    base = flat_base[c]
    valid = (f >= base) & (f < base + tlens[c])
    seg = torch.where(valid, c.to(torch.int32) + 1, 0).reshape(num_rows, row_len)
    pos = torch.where(valid, f - base, 0).reshape(num_rows, row_len)
    offs = torch.arange(lmax, dtype=torch.int32, device=dev)
    tm = offs[None, :] < tlens[:, None]
    gi = torch.where(tm, flat_base[:, None] + offs[None, :], 0)
    return (seg.to(torch.int32), pos.to(torch.int32), gi.to(torch.int64), tm)
