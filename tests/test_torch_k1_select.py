"""K1's wide route above k 16: the radix select (``radix_select_kernel`` in
``medtok_tpu_torch/csrc/topk_l2.cu``) that picks the k nearest codewords
from the sweep's [rows, N] distances. The kernel runs only on the card
(``chip_smoke.py``'s width phase holds it to the plain version there);
here, on the CPU:

- the plain version against the Pallas kernel in interpret mode at k 17
  and 64 (D 64 and 320): values within 1e-5 relative, indices equal but
  where the two picks' distances lie within 1e-5 relative of each other
  (an fp32 tie: the two sum in other orders); exact ties (every codeword
  twice) at k 40 and 41, lowest index first, indices equal;
- the selection's steps emulated in numpy (order-preserving keys with -0
  made +0 and NaN last, the radix select of the k-th key from the row's
  spread, compaction in index order, the sort by (key, index)) against the
  stable sort on rows of signed zeros, subnormals, ties and NaN;
- ``select_smallest`` on CPU tensors (the stable sort) and its checks;
- the launch plan: shared memory within the card's, its routes and chunks
  at 7,000, 21,000 and larger N, no raise for any k up to N, and its
  constants read out of the CUDA source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import vq_pallas
from medtok_tpu_torch.ops import topk_l2
from medtok_tpu_torch.ops.vq import topk_smallest

CSRC = Path(topk_l2.__file__).resolve().parent.parent / "csrc"
SEED = 2461


def _pallas(z, e, k):
    v, i = vq_pallas.fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=k, tile_n=128,
                                   interpret=True)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("k", [17, 64])
@pytest.mark.parametrize("D", [64, 320])
def test_plain_version_matches_pallas_above_the_register_lists(D, k):
    rng = np.random.default_rng(SEED + D + k)
    z = rng.normal(size=(40, D)).astype(np.float32)
    e = rng.normal(size=(300, D)).astype(np.float32)
    jv, ji = _pallas(z, e, k)
    tv, ti = topk_l2.fused_topk_l2(torch.from_numpy(z), torch.from_numpy(e), k=k)
    assert tv.shape == ti.shape == (40, k) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=0)
    # a pick may differ only for one whose distance ties it within 1e-5
    d = topk_l2.squared_distance(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    ti = ti.numpy()
    r, c = np.nonzero(ti != ji)
    assert len(r) <= 0.01 * ti.size
    a, b = d[r, ti[r, c]], d[r, ji[r, c]]
    assert (np.abs(a - b) <= 1e-5 * np.abs(b)).all(), (r, c, a, b)


@pytest.mark.parametrize("k", [40, 41])
def test_plain_version_ranks_exact_ties_lowest_first_above_the_lists(k):
    """Every codeword twice: at k 40 the pairs fill the k places, at k 41
    the k-th place splits a pair, and the lower copy is the one kept."""
    rng = np.random.default_rng(SEED)
    base = rng.normal(size=(60, 320)).astype(np.float32)
    e = np.concatenate([base, base])
    z = rng.normal(size=(16, 320)).astype(np.float32)
    jv, ji = _pallas(z, e, k)
    tv, ti = topk_l2.fused_topk_l2(torch.from_numpy(z), torch.from_numpy(e), k=k)
    ti = ti.numpy()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=0)
    pairs = k // 2
    assert (ti[:, 1:2 * pairs:2] == ti[:, 0:2 * pairs:2] + 60).all()
    assert (ti[:, 0::2] < 60).all()  # the split pair's lower copy at k 41
    np.testing.assert_array_equal(tv.numpy()[:, 1:2 * pairs:2], tv.numpy()[:, 0:2 * pairs:2])


# ------------------------------------------------- the selection's steps --

def order_key(x: np.ndarray) -> np.ndarray:
    """The kernel's order_key: uint32 keys in the order of the values, -0
    as +0, NaN above everything."""
    b = x.astype(np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    key = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    key[np.isnan(x)] = 0xFFFFFFFF
    return key


def radix_select_row(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's steps on one row: the k-th key T by 8-bit digits of key
    - lo from the top bit of the spread, the keys below T and the first
    k - (count below) equal to it in index order, sorted by (key, index);
    values read back from the row."""
    key = order_key(x)
    lo, hi = int(key.min()), int(key.max())
    u = key.astype(np.uint64) - np.uint64(lo)
    top, prefix, krem = (hi - lo).bit_length(), 0, k
    passes = 0
    while top > 0:
        shift = max(top - 8, 0)
        part = (u >> np.uint64(top)) == np.uint64(prefix)
        digit = (u[part] >> np.uint64(shift)) & np.uint64((1 << (top - shift)) - 1)
        incl = np.cumsum(np.bincount(digit.astype(np.int64), minlength=256))
        excl = incl - np.bincount(digit.astype(np.int64), minlength=256)
        d = int(np.nonzero((excl < krem) & (krem <= incl))[0][0])
        prefix, krem, top = (prefix << (top - shift)) | d, krem - int(excl[d]), shift
        passes += 1
    assert passes <= 4
    T = np.uint32(lo + prefix)
    below, equal = np.nonzero(key < T)[0], np.nonzero(key == T)[0]
    assert len(below) == k - krem and len(equal) >= krem >= 1
    surv = np.concatenate([below, equal[:krem]])
    order = np.sort((key[surv].astype(np.uint64) << np.uint64(32)) | surv.astype(np.uint64))
    idx = (order & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return x[idx], idx


def _tricky_rows(rng, B, N):
    """Half the entries from signed zeros, tiny and subnormal values of
    both signs, +-1 and NaN; half normals of scale 1e-6; one row all -0,
    one row a single value."""
    pool = np.array([-0.0, 0.0, -1e-7, 1e-7, -2.5e-6, 2.5e-6, -1.4e-45, 1.4e-45, -1.0, 1.0,
                     np.nan], dtype=np.float32)
    d = np.where(rng.random((B, N)) < 0.5, pool[rng.integers(0, len(pool), (B, N))],
                 (1e-6 * rng.normal(size=(B, N))).astype(np.float32)).astype(np.float32)
    d[0] = -0.0
    d[1] = 0.75
    return d


@pytest.mark.parametrize("k", [17, 64, 301, 1000])
def test_radix_select_steps_match_the_stable_sort(k):
    rng = np.random.default_rng(SEED + k)
    d = _tricky_rows(rng, 8, 1000)
    pv, pi = topk_smallest(torch.from_numpy(d), k)
    for r in range(d.shape[0]):
        v, i = radix_select_row(d[r], k)
        np.testing.assert_array_equal(i, pi[r].numpy())
        np.testing.assert_array_equal(v.view(np.uint32), pv[r].numpy().view(np.uint32))


def test_radix_select_steps_on_distances_of_unit_rows():
    """At the distances of unit rows the steps give the plain version's
    picks."""
    rng = np.random.default_rng(SEED)
    z = rng.normal(size=(6, 320)).astype(np.float32)
    e = rng.normal(size=(2000, 320)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    d = topk_l2.squared_distance(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    for k in (17, 64, 2000):
        pv, pi = topk_smallest(torch.from_numpy(d), k)
        for r in range(d.shape[0]):
            v, i = radix_select_row(d[r], k)
            np.testing.assert_array_equal(i, pi[r].numpy())
            np.testing.assert_array_equal(v, pv[r].numpy())


def test_select_smallest_on_the_cpu_is_the_stable_sort():
    rng = np.random.default_rng(SEED)
    d = torch.from_numpy(_tricky_rows(rng, 4, 300))
    vals, idx = topk_l2.select_smallest(d, 40)
    pv, pi = topk_smallest(d, 40)
    assert idx.dtype == torch.int32 and vals.shape == (4, 40)
    assert torch.equal(idx.long(), pi) and torch.equal(vals.view(torch.int32),
                                                      pv.view(torch.int32))
    assert idx[0].tolist() == list(range(40))  # all -0: index order
    with pytest.raises(ValueError, match="k=301"):
        topk_l2.select_smallest(d, 301)
    with pytest.raises(ValueError, match="float32"):
        topk_l2.select_smallest(d.double(), 4)


# -------------------------------------------------------------- the plan --

@pytest.mark.parametrize("N", [17, 3000, 7000, 21000, 53_000, 100_000, 2_000_000])
def test_select_plan_fits_the_card_for_every_k(N):
    """No raise and shared memory within the card's for any k from 17 to N
    (every k where N is small, a spread of k otherwise); the survivors sort
    in shared memory exactly when k rounds up to at most 4,096; the row's
    keys stay in shared memory exactly when they fit."""
    ks = range(17, N + 1) if N <= 3000 else (17, 64, 1000, 4095, 4096, 4097, N // 2, N)
    for k in ks:
        row_shared, sort_shared, smem = topk_l2.select_plan(N, k)
        assert smem <= topk_l2.SMEM_MAX == 232_448
        assert sort_shared == (k <= 4096)
        assert smem == topk_l2.select_smem(N, k, row_shared, sort_shared)
        assert row_shared == (topk_l2.select_smem(N, k, True, sort_shared) <= topk_l2.SMEM_MAX)


def test_select_smem_counts_each_part():
    # k 64: 64 survivors of 8 bytes, one table of 16 warps x 256 bins, the
    # reductions, 21000 keys and 3 words of slack
    assert topk_l2.select_smem(21000, 64, True, True) == 8 * 64 + 4 * 16 * 256 + 2048 + 4 * 21003
    # k 1000 rounds up to 1,024 survivors; the global sort has two tables
    assert topk_l2.select_smem(21000, 1000, True, True) - topk_l2.select_smem(
        21000, 64, True, True) == 8 * (1024 - 64)
    assert topk_l2.select_smem(21000, 5000, False, False) == 2 * 4 * 16 * 256 + 2048


@pytest.mark.parametrize("B,N,k,rows,row_shared,sort_shared", [
    (4096, 21000, 64, 3195, True, True),      # the timing shape: two chunks
    (4096, 21000, 17, 3195, True, True),
    (4096, 21000, 1000, 3195, True, True),
    (4096, 7000, 64, 4096, True, True),       # the path's region: one chunk
    (4096, 21000, 21000, 639, True, False),   # k = N: the global sort's scratch
    (256, 60000, 64, 256, False, True),       # keys in device memory
    (256, 60000, 60000, 223, False, False),
    (512, 2_000_000, 64, 33, False, True),
])
def test_wide_plan_routes_and_chunks_above_the_lists(B, N, k, rows, row_shared, sort_shared):
    plan = topk_l2.wide_plan(B, N, 320, k, 132)
    assert plan.cap == 0 and plan.rows == rows
    assert (plan.row_shared, plan.sort_shared) == (row_shared, sort_shared)
    assert plan.select_smem == topk_l2.select_smem(N, k, row_shared, sort_shared)
    per_row = N + (0 if sort_shared else 4 * k)
    assert rows * per_row <= topk_l2.WIDE_SCRATCH_FLOATS < (rows + 1) * per_row or rows == B
    base = 2 * (B + N) * plan.dim + B + N + 1
    assert plan.scratch_floats(B, N, k) == base + rows * N + (0 if sort_shared else
                                                              2 + 4 * rows * k)


def test_wide_plan_keeps_the_register_lists_without_a_selection():
    for k in (1, 9, 16):
        plan = topk_l2.wide_plan(4096, 21000, 320, k, 132)
        assert plan.cap and plan.select_smem == 0 and plan.rows == 4096
        assert plan.scratch_floats(4096, 21000, k) == 2 * (4096 + 21000) * 320 + 4096 + 21001


def test_select_constants_are_the_kernels():
    """The plan sizes what csrc/topk_l2.cu lays out: threads, bins, the
    largest shared-memory sort, the reductions' bytes, the card's limit."""
    src = (CSRC / "topk_l2.cu").read_text()

    def const(text, name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        return m.group(1).split("//")[0].strip()

    assert const(src, "SELECT_THREADS") == str(topk_l2.SELECT_THREADS)
    assert const(src, "SELECT_WARPS") == "SELECT_THREADS / 32"
    assert const(src, "SELECT_BINS") == str(topk_l2.SELECT_BINS)
    assert const(src, "SELECT_SORT_MAX") == str(topk_l2.SELECT_SORT_MAX)
    assert const(src, "SELECT_MISC") == str(topk_l2.SELECT_MISC)
    assert const((CSRC / "wide.cuh").read_text(), "X_SMEM_MAX") == str(topk_l2.SMEM_MAX)
    # the C count of shared memory has the plan's four parts
    body = src[src.index("constexpr size_t select_smem("):]
    body = body[:body.index("}")]
    for part in ("8 * (size_t)pow2_at_least(k)", "4 * (size_t)SELECT_WARPS * SELECT_BINS",
                 "(sort_shared ? 1 : 2)", "SELECT_MISC", "4 * ((size_t)N + 3)"):
        assert part in body, part
    # the old k-round selection is gone
    assert "wide_select_kernel" not in src
