"""The arithmetic of kernel K1 (``medtok_tpu_torch/csrc/topk_l2.cu``): 3xTF32
distances on the tensor cores, emulated in plain torch on the CPU, where the
kernel cannot run.

The kernel splits every fp32 value x into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``: nearest, ties away from zero), sums z.e in fp32 as
lo.hi + hi.lo + hi.hi, and takes |x|^2 by a sequential fp32 FMA loop. The
emulation below does the same with integer bit operations and elementwise
fp32 sums; these tests hold it to float64 distances and its selected indices
to the JAX Pallas kernel (interpret mode) on rows without near ties, at the
built widths and at the wide route's (320, 1000; the wide sweep does the same
arithmetic at any width). Inputs are made with numpy from a seed. The wide
sweep's launch plan (``topk_l2.wide_plan``) is held here too."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medtok_tpu.ops.vq_pallas import fused_topk_l2 as jax_fused_topk_l2
from medtok_tpu_torch.ops import _build, topk_l2, vq

K = 5
# embedding widths: three built widths and one that runs zero-padded (to 128)
WIDTHS = (16, 64, 100, 256)
# widths of the wide route: the EHR / export path's 320 and the width
# phase's widest
WIDE = (320, 1000)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    10-bit mantissa, ties away from zero (add half of the 13 dropped bits to
    the magnitude, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def fma_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row by one sequential fp32 FMA loop (x_d^2 is exact in
    float64, so each step rounds the sum once)."""
    s = torch.zeros(x.shape[0], dtype=torch.float32)
    for d in range(x.shape[1]):
        s = (s.double() + x[:, d].double() ** 2).float()
    return s


def distances_3xtf32(z: torch.Tensor, e: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """(|z|^2 + |e|^2) - 2 z.e with z.e summed in fp32 over the TF32 products
    (every product is exact in fp32); ``terms=1`` keeps hi.hi alone."""
    zh, zl = tf32_split(z)
    eh, el = tf32_split(e)
    dot = torch.zeros(z.shape[0], e.shape[0], dtype=torch.float32)
    for d in range(z.shape[1]):
        if terms == 3:
            dot = dot + zl[:, d, None] * eh[None, :, d]
            dot = dot + zh[:, d, None] * el[None, :, d]
        dot = dot + zh[:, d, None] * eh[None, :, d]
    return (fma_sq_norms(z)[:, None] + fma_sq_norms(e)[None, :]) - 2.0 * dot


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _padded(x: np.ndarray) -> torch.Tensor:
    """x zero-padded to the width the kernel runs at, as the wrapper pads:
    the next built width, or (the wide route, above 256) whole 32-column
    chunks as the wide sweep's split kernel writes them."""
    t = torch.from_numpy(x)
    D = t.shape[1]
    width = topk_l2.wide_plan(1, 1, D, 1, 1).dim if D > 256 else \
        _build.kernel_width(D, "embedding width")
    return _build.pad_width(t, width)


def _values(rng, scale: float) -> torch.Tensor:
    """Normal values over several binades, both signs, zeros, and values
    exactly halfway between two TF32 numbers."""
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    half = (x.view(torch.int32) & -0x2000) | 0x1000   # a tie of the rounding
    return torch.cat([x, half.view(torch.float32), torch.zeros(4)])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_tf32_rna_keeps_ten_mantissa_bits(scale):
    x = _values(np.random.default_rng(0), scale)
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # nearest: within half a TF32 ulp (2^-11 relative); ties away from zero
    assert bool(((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())
    ties = (x.view(torch.int32) & 0x1FFF) == 0x1000
    assert int(ties.sum()) >= 4096
    assert bool((hi[ties].abs() > x[ties].abs()).all())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_tf32_split_keeps_22_bits(scale):
    x = _values(np.random.default_rng(1), scale)
    hi, lo = tf32_split(x)
    assert torch.equal(x - hi, (x.double() - hi.double()).float())  # x - hi is exact
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("D", WIDTHS + WIDE)
def test_3xtf32_distances_within_2e6_of_float64(D):
    """Within 2e-6 up to D 256, and past it 2e-6 x sqrt(D / 256): the
    products keep about 22 bits (3 x 2^-22 |z||e| = 7.2e-7 on unit rows at
    any width), while the fp32 chains of the norms and of the sums round
    once a term, an error that grows about as sqrt(D) (3.95e-6 at D 1000,
    still under the 1e-5 gap within which two distances count as tied)."""
    rng = np.random.default_rng(2)
    z, e = _unit(rng, 48, D), _unit(rng, 400, D)
    want = (np.sum(z.astype(np.float64) ** 2, 1)[:, None]
            + np.sum(e.astype(np.float64) ** 2, 1)[None, :]
            - 2.0 * z.astype(np.float64) @ e.astype(np.float64).T)
    got = distances_3xtf32(_padded(z), _padded(e)).double().numpy()
    assert np.abs(got - want).max() <= 2e-6 * max(1.0, math.sqrt(D / 256))
    # one TF32 product alone misses by far more than the 1e-5 tie gap (its
    # errors cancel more over a wider row: 7.2e-5 at D 1000)
    one = distances_3xtf32(_padded(z), _padded(e), terms=1).double().numpy()
    assert np.abs(one - want).max() > (1e-4 if D <= 256 else 5e-5)


@pytest.mark.parametrize("D", WIDTHS + WIDE[:1])
def test_3xtf32_topk_matches_pallas_kernel_on_clean_rows(D):
    """k 5 at the built widths; at D 320 the wide route's timed k, 9."""
    k = 9 if D > 256 else K
    rng = np.random.default_rng(3)
    z, e = _unit(rng, 37, D), _unit(rng, 300, D)
    _, ji = jax_fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=k, tile_b=8,
                              tile_n=128, interpret=True)
    d64 = (np.sum(z.astype(np.float64) ** 2, 1)[:, None]
           + np.sum(e.astype(np.float64) ** 2, 1)[None, :]
           - 2.0 * z.astype(np.float64) @ e.astype(np.float64).T)
    ref = np.sort(d64, axis=1)[:, :k + 1]
    clean = (np.diff(ref, axis=1) > 1e-5).all(axis=1)
    assert clean.sum() >= 30
    _, ti = vq.topk_smallest(distances_3xtf32(_padded(z), _padded(e)), k)
    np.testing.assert_array_equal(ti.numpy()[clean], np.asarray(ji)[clean])


@pytest.mark.parametrize("D", WIDTHS + WIDE[:1])
def test_duplicated_codewords_get_identical_distances(D):
    rng = np.random.default_rng(4)
    base = _unit(rng, 64, D)
    z, e = _unit(rng, 16, D), np.concatenate([base, base])
    d = distances_3xtf32(_padded(z), _padded(e))
    assert torch.equal(d[:, :64], d[:, 64:])
    _, idx = vq.topk_smallest(d, 4)
    assert bool((idx[:, 1] == idx[:, 0] + 64).all() and (idx[:, 3] == idx[:, 2] + 64).all())


@pytest.mark.parametrize("B,N,tile_b,tile_n", [
    (4096, 21000, 128, 64), (4096, 7000, 128, 64), (4097, 21000, 128, 64),
    (1, 21000, 128, 64), (512, 3000, 128, 64), (4096, 21000, 32, 32),
    (40000, 21000, 128, 64),
])
def test_split_plan_covers_every_tile_in_one_wave(B, N, tile_b, tile_n):
    sms = 132
    row_blocks, tiles = math.ceil(B / tile_b), math.ceil(N / tile_n)
    splits, per = topk_l2.split_plan(row_blocks, tiles, sms)
    assert (splits - 1) * per < tiles <= splits * per
    # one wave of one block an SM, or one split when the rows alone need more
    assert row_blocks * splits <= sms or splits == 1
    if B == 4096:  # the export's full shape keeps all but 4 SMs busy
        assert row_blocks * splits >= sms - 4


# (B, N, D, k) the card runs the wide sweep at: wide_times' shape at k 9
# and the path's 5, the path's 7000-row region, the width phase's shapes
# (512 x 3000, a third of it; k 64 writes distances), the width witnesses'
# one row, more z rows than one wave holds, and k above 8 at D 64
WIDE_SHAPES = [(4096, 21000, 320, 9), (4096, 21000, 320, 5), (4096, 7000, 320, 5),
               (512, 3000, 1000, 16), (512, 1000, 257, 9), (512, 3000, 512, 64),
               (1, 5, 264, 1), (40000, 21000, 320, 9), (4096, 21000, 64, 9),
               (256, 21000, 320, 5)]


@pytest.mark.parametrize("B,N,D,k", WIDE_SHAPES)
def test_wide_plan_covers_every_tile_in_one_wave(B, N, D, k):
    """Every 128-row codebook tile in exactly one split (contiguous runs of
    tiles_per_split, none empty), one wave of one block an SM (or one
    split when the row blocks alone fill the card), the width in whole
    32-column chunks, the smallest register list that holds k (else
    distances in chunks within the scratch bound), and shared memory within
    the card's and equal to the kernel's stages."""
    sms = 132
    plan = topk_l2.wide_plan(B, N, D, k, sms)
    assert plan.dim % 32 == 0 and D <= plan.dim < D + 32
    tiles = math.ceil(N / 128)
    runs = [range(y * plan.tiles_per_split, min((y + 1) * plan.tiles_per_split, tiles))
            for y in range(plan.splits)]
    assert sorted(t for r in runs for t in r) == list(range(tiles))
    assert all(len(r) > 0 for r in runs)
    row_blocks, splits = plan.grid
    assert splits == plan.splits and row_blocks == math.ceil(plan.rows / 128)
    assert row_blocks * splits <= sms or splits == 1
    assert plan.cap == (8 if k <= 8 else 16 if k <= 16 else 0)
    if plan.cap:
        assert plan.rows == B
    else:
        assert 1 <= plan.rows <= B and (plan.rows * N <= topk_l2.WIDE_SCRATCH_FLOATS
                                        or plan.rows == 1)
    stage = 2 * (128 + 128) * 32 * 4 + 128 * 4  # z's and the tile's hi / lo, |e|^2
    assert plan.smem == 3 * stage + 16 * 3 <= 232_448


def test_wide_plan_constants_are_the_kernels():
    """The plan sizes what csrc/topk_l2.cu lays out: z rows a block, tile
    rows, chunk columns, stages, the largest list, the warp-specialized
    block of wide.cuh."""
    src = (Path(topk_l2.__file__).resolve().parent.parent / "csrc" / "topk_l2.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        return m.group(1).split("//")[0].strip()

    assert const("KW_TB") == str(topk_l2.WIDE_ROWS)
    assert const("KW_TN") == str(topk_l2.WIDE_TILE)
    assert const("KW_DC") == str(topk_l2.WIDE_CHUNK)
    assert const("KW_STAGES") == str(topk_l2.WIDE_STAGES)
    assert const("KW_CAP") == str(topk_l2.WIDE_CAP)
    assert const("KW_THREADS") == "X_THREADS"
