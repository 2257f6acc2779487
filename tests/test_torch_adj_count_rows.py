"""Kernel K5 (``medtok_tpu_torch/csrc/adj_count.cu``,
``adj_count_tile_kernel``) emulated in numpy from the source's formulas,
fed by launch 1's emulation (``bucket`` of ``test_torch_adj_count_tiles``):
the tile zeroed in shared memory, the list walked in parts of COUNT_CHUNK
entries, each warp's rounds of 32 entries grouped by cell with the group's
first lane adding the group's weights in lane order, and each warp's own
rows written out, float4 where Ln % 4 == 0 and floats otherwise, masked at
the ragged edge. The emulation is held bit for bit to numpy's edge-order
fp32 ``np.add.at`` on fractional weights and to the plain version
``adj_count_reference`` on binary ones, and to the JAX
``scripts/bench_adj.py`` kernel ``pallas_count`` run in interpret mode
(``pallas_call`` patched; no file of the JAX package changes)."""

import json
import os
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_adj_count_tiles import TI, TJ, bf16_bits, bucket, edges, plain

REPO = Path(__file__).resolve().parent.parent

# the kernel's constants
COUNT_WARPS = 8
COUNT_ROWS = TI // COUNT_WARPS
COUNT_CHUNK = 2048
NO_ROW = 0xFF


def walk_round(tile, part, x0, m, warp):
    """One round of warp ``warp``: lane l holds entry x0 + l (NO_ROW past
    m); the lanes whose entries lie in the warp's rows group by cell
    (__match_any_sync on the low 16 bits), and each group's first lane adds
    the group's bf16 weights to the cell, one fp32 add each, in lane order."""
    x = x0 + np.arange(32)
    en = np.where(x < m, part[np.minimum(x, len(part) - 1)], NO_ROW).astype(np.uint32)
    inside = (en & 0xFF) // COUNT_ROWS == warp
    key = np.where(inside, en & 0xFFFF, 0xFFFFFFFF)
    for lane in np.flatnonzero(inside):
        same = np.flatnonzero(key == key[lane])
        if lane != same[0]:            # not the group's first lane
            continue
        cell = int(en[lane] & 0xFF) * TJ + int((en[lane] >> 8) & 0xFF)
        total = tile[cell]
        for g in same:
            total = np.float32(total + (np.uint32(en[g] & 0xFFFF0000)).view(np.float32))
        tile[cell] = total


def tile_kernel(lists, offsets, out, b, t, Ln, tiles_j, parts=None, writes=None):
    """Launch 2 for block (graph b, tile t): writes its cells of ``out``
    [B, Ln, Ln]; ``parts`` collects the length of each part walked and
    ``writes`` counts the writes to each element of ``out``."""
    i0, j0 = (t // tiles_j) * TI, (t % tiles_j) * TJ
    first, length = int(offsets[t]), int(offsets[t + 1] - offsets[t])
    tile = np.full(TI * TJ, np.nan, np.float32)
    for c0 in range(0, length, COUNT_CHUNK):
        m = min(COUNT_CHUNK, length - c0)
        if c0 == 0:
            tile[:] = 0.0
        part = lists[first + c0:first + c0 + m]
        if parts is not None:
            parts.append(m)
        for warp in range(COUNT_WARPS):
            for x0 in range(0, m, 32):
                walk_round(tile, part, x0, m, warp)
    vec = Ln % 4 == 0
    for warp in range(COUNT_WARPS):
        for i in range(warp * COUNT_ROWS, min((warp + 1) * COUNT_ROWS, Ln - i0)):
            row = tile[i * TJ:(i + 1) * TJ]
            if vec:      # a lane's 4 columns, all in or all out, 16-byte aligned
                assert ((b * Ln + i0 + i) * Ln + j0) % 4 == 0
                cols = [4 * lane + k for lane in range(32) if j0 + 4 * lane < Ln for k in range(4)]
            else:        # lane + 32k, masked one by one
                cols = [lane + 32 * k for k in range(TJ // 32) for lane in range(32)
                        if j0 + lane + 32 * k < Ln]
            cols = np.array(cols, np.int64)
            assert (j0 + cols < Ln).all()
            out[b, i0 + i, j0 + cols] = row[cols] if length else 0.0
            if writes is not None:
                writes[b, i0 + i, j0 + cols] += 1


def emulate(src, dst, w, B, Ln, parts=None):
    """The kernel's Count [B, Ln, Ln]: launch 1, then every block of launch 2;
    every element must be written exactly once."""
    Epg = src.shape[0] // B
    src, dst = src.reshape(B, Epg), dst.reshape(B, Epg)
    wb = bf16_bits(w).reshape(B, Epg)
    tiles_j = -(-Ln // TJ)
    out = np.full((B, Ln, Ln), np.nan, np.float32)
    writes = np.zeros((B, Ln, Ln), np.int64)
    for b in range(B):
        lists, offsets = bucket(src[b], dst[b], wb[b], Ln)
        for t in range(len(offsets) - 1):
            tile_kernel(lists, offsets, out, b, t, Ln, tiles_j,
                        parts if b == 0 else None, writes)
    assert (writes == 1).all()
    return out


def edge_order(src, dst, w, B, Ln):
    """numpy's edge-order fp32 Count: np.add.at of the bf16 weights of the
    kept edges (bf16 weight != 0, both ends in [0, Ln)) on float32 zeros."""
    w16 = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    b = np.repeat(np.arange(B), src.shape[0] // B)
    ok = (w16 != 0) & (src >= 0) & (src < Ln) & (dst >= 0) & (dst < Ln)
    count = np.zeros((B, Ln, Ln), np.float32)
    np.add.at(count, (b[ok], dst[ok], src[ok]), w16[ok])
    return count


# (Ln, Epg, options): ragged tiles at Ln = 1, 16, 130, 300 and 203 (Ln % 4
# != 0 at 1, 130, 203: the float path); every edge in one tile, 4608 kept,
# so its list is walked in three parts; indices outside [0, Ln); zero
# weights inside each graph's used slots
CASES = {
    "ln1": (1, 64, {}),
    "ln16": (16, 256, {}),
    "ln130": (130, 2304, {}),
    "ln300": (300, 2560, {}),
    "ln203": (203, 1500, {}),
    "one_tile": (300, 6144, {"lo": 128, "hi": 256}),
    "out_of_range": (130, 1024, {"out_of_range": True}),
    "zeros_inside": (300, 2560, {"zero_every": 3}),
}


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fractional"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_is_the_edge_order_sum(case, binary):
    Ln, Epg, opts = CASES[case]
    B = 2
    rng = np.random.default_rng(Ln + Epg + binary)
    src, dst, w = edges(rng, B, Ln, Epg, binary, **opts)
    parts = []
    got = emulate(src, dst, w, B, Ln, parts)
    np.testing.assert_array_equal(got, edge_order(src, dst, w, B, Ln))
    want = plain(src, dst, w, B, Ln)
    if binary:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    if case == "one_tile":     # every kept edge in tile (1, 1): three parts
        assert parts == [COUNT_CHUNK, COUNT_CHUNK, 3 * Epg // 4 - 2 * COUNT_CHUNK]


def test_a_round_sums_one_cell_in_lane_order():
    """A cell held by several lanes of one round sums their weights in lane
    order: 1 + 2^-24 + 2^-24 in fp32 is 1, while 2^-24 + 2^-24 + 1 is
    1 + 2^-23; entries of other warps' rows and NO_ROW lanes add nothing."""
    def entry(wt, s, d):
        return (int(bf16_bits(np.array([wt], np.float32))[0]) << 16) | (s << 8) | d

    tiny = 2.0 ** -24
    part = np.array([entry(1.0, 5, 3), entry(tiny, 5, 3), entry(tiny, 5, 3),
                     entry(7.0, 5, 3 + COUNT_ROWS), entry(2.0, 6, 3)], np.uint32)
    tile = np.zeros(TI * TJ, np.float32)
    walk_round(tile, part, 0, len(part), warp=0)
    assert tile[3 * TJ + 5] == np.float32(1.0) and tile[3 * TJ + 6] == 2.0
    assert np.count_nonzero(tile) == 2
    tile[:] = 0
    walk_round(tile, part[::-1].copy(), 0, len(part), warp=0)
    assert tile[3 * TJ + 5] == np.float32(1.0 + 2.0 ** -23)
    tile[:] = 0
    walk_round(tile, part, 0, len(part), warp=1)
    assert tile[(3 + COUNT_ROWS) * TJ + 5] == 7.0 and np.count_nonzero(tile) == 1


@pytest.mark.parametrize("Ln", [1, 128, 130, 203, 260])
def test_epilogue_writes_every_element_once(Ln):
    """Empty tiles write zeros without staging; every element of Count is
    written by exactly one lane of one warp of one block."""
    src = np.zeros(4, np.int32)
    w = np.zeros(4, np.float32)      # no kept edge: every list is empty
    got = emulate(src, src, w, 1, Ln)
    np.testing.assert_array_equal(got, np.zeros((1, Ln, Ln), np.float32))


@pytest.fixture
def pallas_count_kernel(monkeypatch):
    """Returns (Ln, Epg) -> the JAX script's pallas_count Count kernel for 8
    graphs, run in interpret mode. The script is run with its argv and
    pallas_call patched to record the kernel and stop the script's own
    timing run."""
    real = pl.pallas_call
    captured = {}

    def record(kernel, **kwargs):
        captured[kernel.__name__] = (kernel, kwargs)
        raise RuntimeError("recorded")

    real_makedirs, real_update = os.makedirs, jax.config.update
    monkeypatch.setattr(os, "makedirs", lambda p, *a, **k: None if str(p) == "/tmp/jax_cache"
                        else real_makedirs(p, *a, **k))
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir" else real_update(name, value))

    def get(Ln, Epg):
        monkeypatch.setattr(pl, "pallas_call", record)
        monkeypatch.setattr(sys, "argv", ["bench_adj.py", "--b", "8", "--ln", str(Ln),
                                          "--epg", str(Epg), "--variants", "pallas"])
        runpy.run_path(str(REPO / "scripts" / "bench_adj.py"), run_name="__main__")
        monkeypatch.setattr(pl, "pallas_call", real)
        kernel, kwargs = captured.pop("count_kernel")
        return real(kernel, interpret=True, **kwargs)

    return get


@pytest.mark.parametrize("case", ["ln1", "ln130", "ln203", "one_tile", "out_of_range",
                                  "zeros_inside"])
def test_emulation_matches_pallas_count(pallas_count_kernel, capsys, case):
    Ln, Epg, opts = CASES[case]
    B = 8
    rng = np.random.default_rng(Ln * Epg + 1)
    src, dst, w = edges(rng, B, Ln, Epg, False, **opts)
    kernel = pallas_count_kernel(Ln, Epg)
    assert "recorded" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "pallas"]["error"]
    want = np.asarray(kernel(*(x.reshape(B * Epg, 1) for x in (src, dst, w))))
    got = emulate(src, dst, w, B, Ln)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    # binary weights: the Pallas kernel's integer sums are exact too
    wbin = (w != 0).astype(np.float32)
    want = np.asarray(kernel(*(x.reshape(B * Epg, 1) for x in (src, dst, wbin))))
    np.testing.assert_array_equal(emulate(src, dst, wbin, B, Ln), want)
