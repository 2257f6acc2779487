"""Port vs JAX in bf16: the plain versions of kernels K2 and K4 (packed
segment attention) against the Pallas kernels in interpret mode at
precision 'default'. The TPU kernels round the probabilities to bf16 before
the P.V product, against the running maximum of 128-key blocks, and take
the row sum over the unrounded ones; the plain versions (and the CUDA
kernels they check) must do the same, at L <= 128 and above it.

Tolerance, per element: one bf16 ulp of the JAX value plus one bf16 ulp of
each term of the P.V sum, 2^-7 * (|want| + sum_j p_j |v_j| / l) + 1e-6. The
second part covers a probability whose bf16 rounding flips between the two
sides because their fp32 scores are summed in another order. And fewer than
1% of the elements may differ at all: without the rounding point about 30%
do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops.flash_attention import packed_segment_attention as jax_psa
from medtok_tpu.ops.flash_attention import packed_segment_attention_nt as jax_psa_nt
from medtok_tpu_torch.ops.flash_attention import (
    packed_segment_attention,
    packed_segment_attention_nt,
    packed_segment_attention_nt_reference,
    packed_segment_attention_reference,
)

ULP = 2.0 ** -7  # bf16 keeps 8 significant bits


def _case(name: str):
    """(B, H, L, Dh, seg [B, L] int32) of a named layout."""
    if name == "packed":
        # 8 segments of 16 per row, the last 10 positions padding
        B, H, L = 2, 3, 128
        seg = np.repeat(np.arange(1, 9, dtype=np.int32), 16)[None].repeat(B, 0)
        seg[:, -10:] = 0
    elif name == "two_blocks":
        # L > 128: two key blocks, so the probabilities of the first round
        # against its own running maximum. Row 0 has runs of 37 (one across
        # the block edge) and 15 positions of padding; in row 1 three
        # interleaved segments span both blocks, with padding every 7th
        B, H, L = 2, 3, 200
        i = np.arange(L)
        seg = np.stack([np.where(i < 185, i // 37 + 1, 0),
                        np.where(i % 7 == 6, 0, i % 3 + 1)]).astype(np.int32)
    else:
        # L not a multiple of 16; row 0 interleaves five segments, row 1 has
        # single-token segments, one segment split in two runs, and padding
        B, H, L = 2, 3, 100
        seg = np.zeros((B, L), np.int32)
        seg[0] = np.arange(L) % 5 + 1
        seg[1, :90] = np.arange(90) + 1
        seg[1, 40:60] = 3
    return B, H, L, 64, seg


def _term_scale(q, k, v, seg) -> np.ndarray:
    """sum_j p_j |v_j| / l in fp32 numpy from [B, H, L, Dh] inputs: the
    size of the P.V terms whose probabilities may round either way."""
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    valid = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    s = np.where(valid, s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    p = np.where(valid, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p / np.where(l == 0, 1, l), np.abs(v))


def _bf16(x: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) of the same values."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _assert_within_one_ulp(got, want, scale):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    tol = ULP * (np.abs(want) + scale) + 1e-6
    assert (diff <= tol).all(), (
        f"{int((diff > tol).sum())} elements beyond one bf16 ulp; max diff "
        f"{diff.max():.3e}")
    differing = float((diff > 0).mean())
    assert differing < 0.01, f"{100 * differing:.2f}% of the elements differ"


@pytest.mark.parametrize("name", ["packed", "interleaved", "two_blocks"])
def test_k2_bf16_plain_version_rounds_like_pallas_kernel(name):
    B, H, L, Dh, seg = _case(name)
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(rng.normal(size=(B, H, L, Dh)).astype(np.float32)) for _ in range(3))
    want = jax_psa(jq, jk, jv, jnp.asarray(seg), interpret=True, precision="default")
    got = packed_segment_attention_reference(tq, tk, tv, torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, L, Dh)
    scale = _term_scale(tq.float(), tk.float(), tv.float(), seg)
    _assert_within_one_ulp(got, want, scale)
    assert (got.float().numpy().transpose(0, 2, 1, 3)[seg == 0] == 0).all()


@pytest.mark.parametrize("name", ["packed", "interleaved", "two_blocks"])
def test_k4_bf16_plain_version_rounds_like_pallas_kernel(name):
    B, H, L, Dh, seg = _case(name)
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(rng.normal(size=(B, L, H, Dh)).astype(np.float32)) for _ in range(3))
    want = jax_psa_nt(jq, jk, jv, jnp.asarray(seg), interpret=True, precision="default")
    got = packed_segment_attention_nt_reference(tq, tk, tv, torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, H, Dh)
    scale = _term_scale(*(t.float().transpose(1, 2) for t in (tq, tk, tv)), seg)
    _assert_within_one_ulp(got, want, scale.transpose(0, 2, 1, 3))
    assert (got.float().numpy()[seg == 0] == 0).all()


def test_bf16_rounding_point():
    """p rounds to bf16 before P.V; l sums the unrounded p. One query, two
    keys with scores 0 and -0.03515625 (after 1/sqrt(64)), so p = (1, p1),
    and v picks out the second probability. At this p1 the bf16 output with
    the rounding differs from the one without it."""
    q = torch.zeros(1, 1, 2, 64)
    q[..., 0] = 1.0
    k = torch.zeros(1, 1, 2, 64)
    k[0, 0, 1, 0] = -0.28125            # a bf16 number: -0.03515625 * 8
    v = torch.zeros(1, 1, 2, 64)
    v[0, 0, 1, 0] = 1.0
    seg = torch.ones(1, 2, dtype=torch.int32)
    p1 = torch.exp(torch.tensor(-0.03515625))
    want = (p1.to(torch.bfloat16).float() / (1.0 + p1)).to(torch.bfloat16)
    assert want != (p1 / (1.0 + p1)).to(torch.bfloat16)
    out = packed_segment_attention_reference(*(t.bfloat16() for t in (q, k, v)), seg)
    assert out[0, 0, 0, 0] == want
    # fp32 inputs keep the unrounded probabilities
    out32 = packed_segment_attention_reference(q, k, v, seg)
    assert torch.allclose(out32[0, 0, 0, 0], p1 / (1.0 + p1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("wrapper,plain,heads_dim", [
    (packed_segment_attention, packed_segment_attention_reference, 1),
    (packed_segment_attention_nt, packed_segment_attention_nt_reference, 2),
])
def test_bf16_wrappers_take_plain_version_on_cpu(wrapper, plain, heads_dim):
    B, H, L, Dh, seg = _case("interleaved")
    shape = [B, L, Dh]
    shape.insert(heads_dim, H)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for _ in range(3))
    launches = wrapper.launches
    out = wrapper(q, k, v, torch.from_numpy(seg))
    assert wrapper.launches == launches
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, plain(q, k, v, torch.from_numpy(seg)))
