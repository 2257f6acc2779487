"""The arithmetic of kernel K1 (``medtok_tpu_torch/csrc/topk_l2.cu``): 3xTF32
distances on the tensor cores, emulated in plain torch on the CPU, where the
kernel cannot run.

The kernel splits every fp32 value x into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``: nearest, ties away from zero), sums z.e in fp32 as
lo.hi + hi.lo + hi.hi, and takes |x|^2 by a sequential fp32 FMA loop. The
emulation below does the same with integer bit operations and elementwise
fp32 sums; these tests hold it to float64 distances and its selected indices
to the JAX Pallas kernel (interpret mode) on rows without near ties. Inputs
are made with numpy from a seed."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medtok_tpu.ops.vq_pallas import fused_topk_l2 as jax_fused_topk_l2
from medtok_tpu_torch.ops import _build, topk_l2, vq

K = 5
# embedding widths: three built widths and one that runs zero-padded (to 128)
WIDTHS = (16, 64, 100, 256)


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
    """x zero-padded to the width the kernel runs at, as the wrapper pads."""
    t = torch.from_numpy(x)
    return _build.pad_width(t, _build.kernel_width(t.shape[1], "embedding width"))


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


@pytest.mark.parametrize("D", WIDTHS)
def test_3xtf32_distances_within_2e6_of_float64(D):
    rng = np.random.default_rng(2)
    z, e = _unit(rng, 48, D), _unit(rng, 400, D)
    want = (np.sum(z.astype(np.float64) ** 2, 1)[:, None]
            + np.sum(e.astype(np.float64) ** 2, 1)[None, :]
            - 2.0 * z.astype(np.float64) @ e.astype(np.float64).T)
    got = distances_3xtf32(_padded(z), _padded(e)).double().numpy()
    assert np.abs(got - want).max() <= 2e-6
    # one TF32 product alone misses by far more than the 1e-5 tie gap
    one = distances_3xtf32(_padded(z), _padded(e), terms=1).double().numpy()
    assert np.abs(one - want).max() > 1e-4


@pytest.mark.parametrize("D", WIDTHS)
def test_3xtf32_topk_matches_pallas_kernel_on_clean_rows(D):
    rng = np.random.default_rng(3)
    z, e = _unit(rng, 37, D), _unit(rng, 300, D)
    _, ji = jax_fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=K, tile_b=8,
                              tile_n=128, interpret=True)
    d64 = (np.sum(z.astype(np.float64) ** 2, 1)[:, None]
           + np.sum(e.astype(np.float64) ** 2, 1)[None, :]
           - 2.0 * z.astype(np.float64) @ e.astype(np.float64).T)
    ref = np.sort(d64, axis=1)[:, :K + 1]
    clean = (np.diff(ref, axis=1) > 1e-5).all(axis=1)
    assert clean.sum() >= 30
    _, ti = vq.topk_smallest(distances_3xtf32(_padded(z), _padded(e)), K)
    np.testing.assert_array_equal(ti.numpy()[clean], np.asarray(ji)[clean])


@pytest.mark.parametrize("D", WIDTHS)
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
