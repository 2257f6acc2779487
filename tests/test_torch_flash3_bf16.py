"""Port vs JAX in bf16 at the EHR encoder's blocks: the plain versions of
kernel K3 (flash attention forward, dq and dk/dv) against the Pallas
kernels in interpret mode at their default blocks (block_q 256, block_k
512) and precision 'default', as ``medtok_tpu/models/layers.py`` calls
them. The TPU forward rounds the probabilities to bf16 before P.V against
the running maximum of 512-key blocks and sums l over the unrounded ones;
the plain version (and the CUDA kernel it checks) must round at the same
point. The backward recomputes a = exp(s - lse) with no running maximum and
rounds ds and the dropped probabilities before their products.

Tolerance of a bf16 element of the forward: one bf16 ulp of the JAX value
plus one bf16 ulp of each term of its sum, 2^-7 * (|want| + sum_j p~_j
|v_j| / l) + 1e-6. The second part covers a term whose bf16 rounding flips
between the two sides because their fp32 scores are summed in another
order. A gradient's terms (in dQ sm_scale |ds_ij| |k_j|, in dK sm_scale
|ds_ij| |q_i|, in dV |a~_ij| |dO_i|) sum to many times its value, so it is
held to 2^-7 * sum of |terms| + 1e-6. Fewer than 1% of the elements may
differ at all: with the row maximum as the forward's rounding point 17.6%
of its elements did at this shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu_torch.ops import flash_attention as fa

ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
SEED = 1234


def _inputs(seed=0, B=2, H=2, L=1100, Dh=16, lens=(1100, 700)):
    """q, k, v, dO [B, H, L, Dh] fp32 from a numpy seed and a [B, L] key
    mask with the given key lengths (padding is a suffix, as in the EHR
    batches)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(4))
    mask = np.arange(L)[None] < np.asarray(lens)[:, None]
    return q, k, v, do, mask


def _bf16(*xs):
    """The fp32 arrays rounded to bf16: (jax arrays, torch tensors)."""
    ts = [torch.from_numpy(x).bfloat16() for x in xs]
    return [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts], ts


def _jax_side(jq, jk, jv, do, mask, rate):
    """out, dq, dk, dv of the Pallas kernels at their default blocks."""
    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), dropout_rate=rate,
                                  dropout_seed=SEED, interpret=True, precision="default")
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _assert_within_one_ulp(name, got, want, terms, max_share, value_ulp=True):
    """Every element within one bf16 ulp of want plus one of its terms
    (value_ulp False: within one ulp of each term, which for a gradient sum
    to many times its value); under max_share of them differing. Returns
    the share that differs."""
    diff = np.abs(got - want)
    tol = ULP * ((np.abs(want) if value_ulp else 0.0) + terms) + 1e-6
    assert (diff <= tol).all(), (
        f"{name}: {int((diff > tol).sum())} elements beyond one bf16 ulp of their "
        f"terms; max diff {diff.max():.3e}")
    share = float((diff > 0).mean())
    assert share < max_share, f"{name}: {100 * share:.3f}% of the elements differ"
    return share


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_bf16_plain_forward_rounds_like_pallas_kernel(rate):
    q, k, v, _, mask = _inputs()
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    want = jfa.flash_attention(jq, jk, jv, jnp.asarray(mask), dropout_rate=rate,
                               dropout_seed=SEED, interpret=True, precision="default")
    kw = dict(dropout_rate=rate, dropout_seed=SEED)
    tmask = torch.from_numpy(mask)
    got, _ = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    # sum_j p~_j |v_j| / l: the plain version on fp32 copies and |v|
    terms, _ = fa.flash_attention_reference(tq.float(), tk.float(), tv.float().abs(),
                                            tmask, **kw)
    _assert_within_one_ulp("out", got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                           terms.numpy(), 0.01)


def test_bf16_rounding_point_is_the_512_key_block():
    """The fault's witness: one query, Lk = 513, every score 0 in the first
    512-key block and the largest score, 1, in the second. The TPU kernel
    rounds the first block's probabilities against that block's maximum
    (p = 1) and rescales by exp(-1) afterwards; rounding against the row
    maximum gives p = bf16(exp(-1)) instead. v picks out key 0."""
    Lk, Dh = 513, 16
    q = np.zeros((1, 1, 1, Dh), np.float32)
    q[..., 0] = 1.0
    k = np.zeros((1, 1, Lk, Dh), np.float32)
    k[0, 0, 512, 0] = 4.0                      # score 1.0 after 1/sqrt(16)
    v = np.zeros((1, 1, Lk, Dh), np.float32)
    v[0, 0, 0, 0] = 1.0
    mask = np.ones((1, Lk), bool)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    e1 = torch.exp(torch.tensor(-1.0))
    l = 512 * e1 + 1
    expected = (e1 / l).bfloat16()                          # 0.00194549560546875
    row_max = (e1.bfloat16().float() / l).bfloat16()        # 0.0019378662109375
    assert expected != row_max
    jout = jfa.flash_attention(jq, jk, jv, jnp.asarray(mask), interpret=True,
                               precision="default")
    assert float(jout[0, 0, 0, 0]) == float(expected)
    out, _ = fa.flash_attention_reference(tq, tk, tv, torch.from_numpy(mask))
    assert out[0, 0, 0, 0] == expected
    # at fp32 there is no rounding point: the exact value
    out32, _ = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                            torch.from_numpy(mask))
    assert torch.allclose(out32[0, 0, 0, 0], e1 / l, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_bf16_grads_match_pallas_backward(rate):
    """dq / dk / dv through the autograd Function against jax.value_and_grad
    of the Pallas version, by the per-term rule. Both sides take D = dO . O
    from their own bf16 output, which differs in under 1% of its elements,
    so where it does a row's ds all shift together; under 1% of the
    gradients' elements differ all the same (about 0.1% here)."""
    q, k, v, do, mask = _inputs(seed=1)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    want = _jax_side(jq, jk, jv, do, mask, rate)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    kw = dict(sm_scale=0.25, dropout_rate=rate, dropout_seed=SEED)
    out = fa.flash_attention(*leaves, tmask, **kw)
    (out.float() * tdo).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    _, lse = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    g = tdo.bfloat16()
    delta = (g.float() * out.detach().float()).sum(-1)
    terms = fa.flash_attention_grad_terms(tq, tk, tv, tmask, lse, delta, g, **kw)
    for name, got, w, t in zip(("dq", "dk", "dv"), leaves, want[1:], terms):
        _assert_within_one_ulp(name, got.grad.float().numpy(), w, t.numpy(), 0.01,
                               value_ulp=False)
    # keys past row 1's length get zero gradients on both sides
    for got, w in zip(leaves[1:], want[2:]):
        assert not got.grad[1, :, 700:].any() and not w[1, :, 700:].any()


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fp32_forward_and_grads_at_default_blocks(rate):
    """fp32 keeps fp32 probabilities: the port's walk over 512-key blocks
    and the Pallas kernel at 'highest' differ only in summation order."""
    q, k, v, do, mask = _inputs(seed=2)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), dropout_rate=rate,
                                  dropout_seed=SEED, interpret=True, precision="highest")
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, torch.from_numpy(mask), dropout_rate=rate,
                             dropout_seed=SEED)
    (out * torch.from_numpy(do)).sum().backward()
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *(t.grad for t in leaves)),
                            (jout, *jgrads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=name)
