"""Kernel K5-lane (``medtok_tpu_torch/csrc/adj_count.cu``,
``adj_count_onehot_kernel``) emulated in numpy from the source's index
formulas: which edges a Count tile keeps and in which order (ballot ranks
and the warps' block prefix), the 4-byte packing, the stable sort by 16-row
slab with each run padded to 16, the ``mma.sync.m16n8k16`` A and B fragment
values of each lane (g, t), and the fp32 sums of each fragment. The
emulation is held to the plain version ``adj_count_reference`` (bit for bit
on binary weights, within 1e-6 of the largest count on fractional ones) and
to the JAX ``scripts/bench_adj.py`` kernel ``pallas_lane`` run in interpret
mode (``pallas_call`` patched; no file of the JAX package changes)."""

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

from medtok_tpu_torch.ops.adj_count import adj_count_onehot, adj_count_reference

REPO = Path(__file__).resolve().parent.parent

# the kernel's constants
TI = TJ = 128
LANE_WARPS = TI // 16
LANE_CHUNK = 2048
LIST_CAP = 2 * LANE_CHUNK
NFRAG = TJ // 8
HALF = NFRAG // 2
BUCKET_WARPS = 16
BUCKET_TILES = 512
BF16_ONE = 0x3F80
LANES = np.arange(32, dtype=np.uint32)
G, T = LANES // 4, LANES % 4


def bf16_bits(w: np.ndarray) -> np.ndarray:
    """bf16(w) as uint32 bit patterns (round to nearest even)."""
    h = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(torch.bfloat16)
    return h.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def popc(x) -> np.ndarray:
    return np.bitwise_count(np.asarray(x, np.uint64)).astype(np.int64)


LANE_BITS = np.uint64(1) << LANES.astype(np.uint64)


def ballot(pred: np.ndarray) -> np.ndarray:
    """__ballot_sync over the last axis (32 lanes)."""
    return np.sum(np.where(pred, LANE_BITS, np.uint64(0)), axis=-1, dtype=np.uint64)


def ranks(mask: np.ndarray) -> np.ndarray:
    """popc(mask & lanemask_lt) for each lane: [..., 32]."""
    return popc(np.asarray(mask, np.uint64)[..., None] & (LANE_BITS - np.uint64(1)))


def lane_bit(mask: np.ndarray) -> np.ndarray:
    return (np.asarray(mask, np.uint64)[..., None] >> LANES.astype(np.uint64)) & np.uint64(1) == 1


def bucket(src, dst, wb, Ln):
    """Launch 1 for one graph: each tile's list (the stable counting sort
    by tile) and the offsets [tiles + 1]. Warp w scans its sixteenth of the
    slots in rounds of 32 lanes; a first pass counts its edges by tile, a
    prefix over (tile, warp) gives the write positions, and in the second
    pass __match_any_sync groups the lanes of one tile, whose rank is the
    popc of the group below the lane."""
    Epg = src.shape[0]
    tiles_j = -(-Ln // TJ)
    tiles = -(-Ln // TI) * tiles_j
    seg = -(-Epg // BUCKET_WARPS)
    lists = np.full(Epg, 0xDEADBEEF, np.uint32)
    offsets = np.zeros(tiles + 1, np.int64)
    base = 0
    for g0 in range(0, tiles, BUCKET_TILES):
        ng = min(BUCKET_TILES, tiles - g0)
        cur = np.zeros((BUCKET_WARPS, BUCKET_TILES), np.int64)
        for pass_ in range(2):
            for warp in range(BUCKET_WARPS):
                s0, s1 = min(warp * seg, Epg), min(warp * seg + seg, Epg)
                for x0 in range(s0, s1, 32):
                    x = x0 + LANES.astype(np.int64)
                    e = np.minimum(x, s1 - 1)
                    s, d, w = src[e].astype(np.int64), dst[e].astype(np.int64), wb[e]
                    keep = (x < s1) & (s >= 0) & (s < Ln) & (d >= 0) & (d < Ln) & ((w & 0x7FFF) != 0)
                    tile = (d // TI) * tiles_j + s // TJ - g0
                    key = np.where(keep & (tile >= 0) & (tile < ng), tile, -1)
                    if pass_ == 0:    # counts (shared atomicAdd in the kernel)
                        np.add.at(cur[warp], key[key >= 0], 1)
                        continue
                    same = [ballot(key == k) for k in key]              # __match_any_sync
                    c = np.where(key >= 0, cur[warp, np.maximum(key, 0)], 0)
                    rank = np.array([int(popc(int(m) & ((1 << lane) - 1))) for lane, m in enumerate(same)])
                    ent = (w << 16) | ((s % TJ) << 8).astype(np.uint32) | (d % TI).astype(np.uint32)
                    lists[(c + rank)[key >= 0]] = ent[key >= 0]
                    for lane in range(32):                              # the leaders
                        if key[lane] >= 0 and lane == (int(same[lane]) & -int(same[lane])).bit_length() - 1:
                            cur[warp, key[lane]] = c[lane] + int(popc(same[lane]))
            if pass_ == 0:
                tot = cur.sum(axis=0)
                start = base + np.cumsum(tot) - tot
                cur = start[None, :] + np.cumsum(cur, axis=0) - cur
                offsets[g0:g0 + ng] = start[:ng]
                base += int(tot.sum())
    offsets[tiles] = base
    return lists, offsets


def tile_count(lists, offsets, tile, log=None):
    """Launch 2 for one (graph, tile): copy the list LANE_CHUNK entries at
    a time, sort and multiply when the list may not take another copy or
    at the end; the [TI, TJ] fp32 sums (Count reads them back after an
    earlier sort, so carrying them is the same)."""
    acc = np.zeros((TI, TJ), np.float32)
    lst = np.zeros(LIST_CAP, np.uint32)
    first, length = int(offsets[tile]), int(offsets[tile + 1] - offsets[tile])
    n = 0
    for c0 in range(0, length, LANE_CHUNK):
        m = min(LANE_CHUNK, length - c0)
        lst[n:n + m] = lists[first + c0:first + c0 + m]
        n += m
        if n <= LIST_CAP - LANE_CHUNK and c0 + LANE_CHUNK < length:
            continue
        if log is not None:
            log.append(lst[:n].copy())
        sorted_, runs = slab_sort(lst, n)
        for warp, (off, end) in enumerate(runs):
            for k0 in range(off, end, 16):
                products(acc[16 * warp:16 * warp + 16], sorted_[k0:k0 + 16])
        n = 0
    return acc


def slab_sort(lst, n):
    """Step 2: the list split stably by slab, each run padded to 16 with
    zero entries; returns the sorted array and each warp's [off, end)."""
    sorted_ = np.full(LIST_CAP + 15 * LANE_WARPS, 0xDEADBEEF, np.uint32)
    x = np.arange(0, -(-n // 32) * 32).reshape(-1, 32)            # [round, lane]
    en = np.where(x < n, lst[np.minimum(x, LIST_CAP - 1)], 0).astype(np.uint32)
    masks = [ballot((x < n) & ((en & 0xFF) >> 4 == warp)) for warp in range(LANE_WARPS)]
    slab_cnt = [int(popc(m).sum()) for m in masks]
    runs = []
    for warp, m in enumerate(masks):
        off = sum((c + 15) & ~15 for c in slab_cnt[:warp])
        per_round = popc(m)
        pos = (off + np.cumsum(per_round) - per_round)[:, None] + ranks(m)
        mine = lane_bit(m)
        sorted_[pos[mine]] = en[mine]
        p = off + slab_cnt[warp]
        end = off + ((slab_cnt[warp] + 15) & ~15)
        pad = p + LANES.astype(np.int64)
        sorted_[pad[pad < end]] = 0
        runs.append((off, end))
    return sorted_, runs


def a_pair(lo, hi, row):
    return (np.where((lo & 15) == row, lo >> 16, 0)
            | np.where((hi & 15) == row, hi & 0xFFFF0000, 0)).astype(np.uint32)


def frag_bit(en, cb):
    """1 << f when the entry's local src is column 8f + g of a half whose
    first column plus g is cb, else 0."""
    u = ((en >> 8) & 0xFF).astype(np.int64) - cb
    return np.where((u % 8 == 0) & (u >= 0) & (u < 8 * HALF), 1 << (np.maximum(u, 0) >> 3), 0)


def lane_fragments(group):
    """The registers lane (g, t) builds from 16 sorted entries: a [32, 4]
    and b [NFRAG, 32, 2] (two bf16 values a register, lower k low); the B
    registers of fragment f of half h come from the entries' fragment bits,
    (m >> f & 0x10001) * bf16(1)."""
    lo = np.stack([group[2 * T], group[2 * T + 1]])
    hi = np.stack([group[2 * T + 8], group[2 * T + 9]])
    a = np.stack([a_pair(lo[0], lo[1], G), a_pair(lo[0], lo[1], G + 8),
                  a_pair(hi[0], hi[1], G), a_pair(hi[0], hi[1], G + 8)], axis=1)
    b = []
    for h in range(2):
        cb = 8 * HALF * h + G.astype(np.int64)
        m01 = frag_bit(lo[0], cb) | frag_bit(lo[1], cb) << 16
        m89 = frag_bit(hi[0], cb) | frag_bit(hi[1], cb) << 16
        b += [np.stack([((m01 >> f) & 0x10001) * BF16_ONE, ((m89 >> f) & 0x10001) * BF16_ONE],
                       axis=1).astype(np.uint32) for f in range(HALF)]
    return a, np.stack(b)


def products(acc_slab, group):
    """Step 3 for one group of 16 entries: the lanes' fragments unpacked by
    the m16n8k16 layout, multiplied and added in fp32 to the slab's rows."""
    A, B = unpack(*lane_fragments(group))
    # fragment f holds columns 8f .. 8f + 7 of the slab's TJ
    acc_slab += bf16_value(A).astype(np.float64) @ bf16_value(B).transpose(1, 0, 2).reshape(16, TJ)


def unpack(a, b):
    """The lanes' registers placed by the m16n8k16 layout: A [16, 16] and
    B [NFRAG, 16, 8] bf16 bit patterns."""
    A = np.zeros((16, 16), np.uint32)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for half in range(2):
            A[G + dr, 2 * T + half + dk] = (a[:, reg] >> (16 * half)) & 0xFFFF
    B = np.zeros((NFRAG, 16, 8), np.uint32)
    for reg, dk in enumerate((0, 8)):
        for half in range(2):
            B[:, 2 * T + half + dk, G] = (b[:, :, reg] >> (16 * half)) & 0xFFFF
    return A, B


def emulate(src, dst, w, B: int, Ln: int, log=None) -> np.ndarray:
    """The kernel's Count [B, Ln, Ln] (each tile written by its block)."""
    Epg = src.shape[0] // B
    src, dst = src.reshape(B, Epg), dst.reshape(B, Epg)
    wb = bf16_bits(w).reshape(B, Epg)
    tiles_j = -(-Ln // TJ)
    out = np.full((B, Ln, Ln), np.nan, np.float32)
    for b in range(B):
        lists, offsets = bucket(src[b], dst[b], wb[b], Ln)
        for tile in range(len(offsets) - 1):
            i0, j0 = (tile // tiles_j) * TI, (tile % tiles_j) * TJ
            acc = tile_count(lists, offsets, tile, log if log is not None and b == 0 else None)
            out[b, i0:i0 + TI, j0:j0 + TJ] = acc[:Ln - i0, :Ln - j0]
    return out


def plain(src, dst, w, B, Ln) -> np.ndarray:
    return adj_count_reference(*map(torch.from_numpy, (src, dst, w)), B, Ln).numpy()


def edges(rng, B, Ln, Epg, binary, lo=0, hi=None, zero_every=0, out_of_range=False):
    """Per-graph edges with indices in [lo, hi), the last quarter of each
    graph's slots weight 0; zero weights also every zero_every-th slot;
    optionally a sixth of the indices moved outside [0, Ln)."""
    hi = Ln if hi is None else hi
    src = rng.integers(lo, hi, (B, Epg)).astype(np.int32)
    dst = rng.integers(lo, hi, (B, Epg)).astype(np.int32)
    w = (np.ones((B, Epg)) if binary else rng.random((B, Epg)) * 2 - 0.5).astype(np.float32)
    w[:, 3 * Epg // 4:] = 0.0
    if zero_every:
        w[:, ::zero_every] = 0.0
    if out_of_range:
        bad = rng.random((2, B, Epg)) < 1 / 6
        far = rng.choice(np.array([-1, Ln, -(2 ** 31), 2 ** 31 - 1, -Ln, 2 * Ln], np.int64),
                         (2, B, Epg)).astype(np.int32)
        src = np.where(bad[0], far[0], src)
        dst = np.where(bad[1], far[1], dst)
    return src.reshape(-1), dst.reshape(-1), w.reshape(-1)


def assert_matches(got, want, binary):
    if binary:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


# (Ln, Epg, options): ragged tiles at Ln = 1, 16, 130, 300; every edge in one
# tile with more edges than one chunk (two sorts); indices outside [0, Ln);
# zero weights inside each graph's used slots; Epg no multiple of the chunk
CASES = {
    "ln1": (1, 64, {}),
    "ln16": (16, 256, {}),
    "ln130": (130, 2304, {}),
    "ln300": (300, 2560, {}),
    "one_tile": (300, 6144, {"lo": 128, "hi": 256}),
    "out_of_range": (130, 1024, {"out_of_range": True}),
    "zeros_inside": (300, 2560, {"zero_every": 3}),
}


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fractional"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plain_version(case, binary):
    Ln, Epg, opts = CASES[case]
    B = 2
    rng = np.random.default_rng(Ln + Epg + binary)
    src, dst, w = edges(rng, B, Ln, Epg, binary, **opts)
    log = []
    got = emulate(src, dst, w, B, Ln, log)
    assert not np.isnan(got).any()          # every element written once
    assert_matches(got, plain(src, dst, w, B, Ln), binary)
    if case == "one_tile":                   # more kept edges than a chunk: two sorts
        assert [len(x) for x in log if len(x)] == [2 * LANE_CHUNK, 3 * Epg // 4 - 2 * LANE_CHUNK]


@pytest.mark.parametrize("Ln,Epg", [(300, 2500), (4200, 700)], ids=["ln300", "two_tile_groups"])
def test_bucket_lists_are_edge_order_and_packing(Ln, Epg):
    """Launch 1: each tile's list holds exactly its edges of weight != 0
    with both ends in [0, Ln), in edge order, as bf16 bits << 16 | local src
    << 8 | local dst; the tiles' lists follow one another from slot 0 and
    no other slot is written. At Ln = 4200 (1089 tiles) the tiles are
    counted in three groups of up to BUCKET_TILES."""
    rng = np.random.default_rng(7)
    src, dst, w = edges(rng, 1, Ln, Epg, False, zero_every=5, out_of_range=True)
    wb = bf16_bits(w)
    lists, offsets = bucket(src, dst, wb, Ln)
    tiles_j = -(-Ln // TJ)
    assert offsets[0] == 0 and (np.diff(offsets) >= 0).all()
    assert (lists[offsets[-1]:] == 0xDEADBEEF).all()
    for tile in range(len(offsets) - 1):
        i0, j0 = (tile // tiles_j) * TI, (tile % tiles_j) * TJ
        keep = ((dst >= i0) & (dst < min(i0 + TI, Ln)) & (src >= j0) & (src < min(j0 + TJ, Ln))
                & ((wb & 0x7FFF) != 0))
        want = (wb[keep] << 16) | ((src[keep] - j0).astype(np.uint32) << 8) | (dst[keep] - i0)
        np.testing.assert_array_equal(lists[offsets[tile]:offsets[tile + 1]], want.astype(np.uint32))


def test_slab_sort_is_stable_and_padded():
    rng = np.random.default_rng(3)
    n = 700
    lst = np.zeros(LIST_CAP, np.uint32)
    lst[:n] = ((rng.integers(1, 1 << 16, n).astype(np.uint32) << 16)
               | (rng.integers(0, 128, n).astype(np.uint32) << 8)
               | rng.integers(0, 128, n).astype(np.uint32))
    sorted_, runs = slab_sort(lst, n)
    assert runs[0][0] == 0 and all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    for slab, (off, end) in enumerate(runs):
        mine = lst[:n][(lst[:n] & 0xFF) >> 4 == slab]
        assert off % 16 == 0 and end - off == -(-len(mine) // 16) * 16
        np.testing.assert_array_equal(sorted_[off:off + len(mine)], mine)
        assert (sorted_[off + len(mine):end] == 0).all()


def test_lane_fragments_are_the_one_hots():
    """Unpacked by the m16n8k16 layout, the lanes' registers are the bf16
    one-hot A = w 1[dst = row] and B = 1[src = col] of the 16 entries."""
    rng = np.random.default_rng(11)
    d = rng.integers(0, 16, 16).astype(np.uint32) + 16 * 5      # slab 5
    s = rng.integers(0, 128, 16).astype(np.uint32)
    wb = bf16_bits(rng.random(16).astype(np.float32) + 0.1)
    group = (wb << 16) | (s << 8) | d
    A, Bs = unpack(*lane_fragments(group))
    want_a = np.where((d % 16)[None, :] == np.arange(16)[:, None], wb[None, :], 0)
    np.testing.assert_array_equal(A, want_a)
    for f in range(NFRAG):
        want_b = np.where(s[:, None] == 8 * f + np.arange(8)[None, :], BF16_ONE, 0)
        np.testing.assert_array_equal(Bs[f], want_b)


@pytest.fixture
def pallas_lane_kernel(monkeypatch):
    """Returns (Ln, Epg) -> the JAX script's pallas_lane Count kernel for 8
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
                                          "--epg", str(Epg), "--variants", "pallas_lane"])
        runpy.run_path(str(REPO / "scripts" / "bench_adj.py"), run_name="__main__")
        monkeypatch.setattr(pl, "pallas_call", real)
        kernel, kwargs = captured.pop("count_kernel_lane")
        return real(kernel, interpret=True, **kwargs)

    return get


@pytest.mark.parametrize("case", ["ln1", "ln130", "one_tile", "out_of_range", "zeros_inside"])
def test_emulation_matches_pallas_lane(pallas_lane_kernel, capsys, case):
    Ln, Epg, opts = CASES[case]
    B = 8
    rng = np.random.default_rng(Ln * Epg)
    src, dst, w = edges(rng, B, Ln, Epg, False, **opts)
    kernel = pallas_lane_kernel(Ln, Epg)
    assert "recorded" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "pallas_lane"]["error"]
    want = np.asarray(kernel(*(x.reshape(B, Epg) for x in (src, dst, w))))
    got = emulate(src, dst, w, B, Ln)
    assert_matches(got, want, False)
    # binary weights: the Pallas kernel's integer sums are exact too
    wbin = (w != 0).astype(np.float32)
    want = np.asarray(kernel(*(x.reshape(B, Epg) for x in (src, dst, wbin))))
    assert_matches(emulate(src, dst, wbin, B, Ln), want, True)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    src, dst, w = edges(rng, 3, 130, 300, False, out_of_range=True)
    before = adj_count_onehot.launches
    got = adj_count_onehot(*map(torch.from_numpy, (src, dst, w)), 3, 130).numpy()
    assert adj_count_onehot.launches == before
    np.testing.assert_array_equal(got, plain(src, dst, w, 3, 130))


def test_plain_version_drops_out_of_range_indices_like_jax():
    """An index outside [0, Ln) matches no one-hot row of the JAX Count
    (``medtok_tpu/models/layers.py::gcn_norm_adj``); the port's plain
    version raised an IndexError there. Smallest input: one edge 0 -> 1 at
    Ln = 1, where JAX gives the identity adjacency."""
    import jax.numpy as jnp

    from medtok_tpu.models.layers import gcn_norm_adj as jax_gcn_norm_adj
    from medtok_tpu_torch.models.layers import gcn_norm_adj

    one = np.array([0], np.int32), np.array([1], np.int32), np.array([1.0], np.float32)
    want = np.asarray(jax_gcn_norm_adj(*map(jnp.asarray, one), 1, 1))
    np.testing.assert_array_equal(want, [[[1.0]]])
    np.testing.assert_array_equal(gcn_norm_adj(*map(torch.from_numpy, one), 1, 1).numpy(), want)

    rng = np.random.default_rng(13)
    src, dst, w = edges(rng, 3, 40, 200, False, out_of_range=True)
    want = np.asarray(jax_gcn_norm_adj(*map(jnp.asarray, (src, dst, w)), 3, 40))
    got = gcn_norm_adj(*map(torch.from_numpy, (src, dst, w)), 3, 40).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
