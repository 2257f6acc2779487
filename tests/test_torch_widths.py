"""Port vs JAX at widths other than the kernels' native ones (K3: 16, K2 /
K4: 64, K1: 64). The CUDA kernels are built at widths 16, 32, 64, 128 and
256 and their wrappers zero-pad any other width from 1 to 256 up to the
next of those; this file holds, on the CPU:

- the plain versions, which the kernels are checked against on the card,
  against the Pallas kernels in interpret mode at such widths: K3's forward
  and gradients (fp32 within 1e-5, the two sides differing only in
  summation order; bf16 at precision 'default' within one bf16 ulp of each
  term, as in tests/test_torch_flash3_bf16.py), K2 / K4 (the same rules),
  K1's indices (equal);
- the padding rule itself: each plain version on zero-padded inputs with
  the true sm_scale, cut back, equals it on the unpadded inputs (zero
  columns add exact zeros, but a matmul may group its sums differently at
  another width, so fp32 results agree within 1e-6 relative);
- the wrappers' shape checks, called on CPU tensors: every width in 1..256
  takes a built kernel, a wider one (and K1's k above 8) the wide route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu.ops import vq_pallas
from medtok_tpu_torch.ops import _build
from medtok_tpu_torch.ops import flash_attention as fa
from medtok_tpu_torch.ops import topk_l2

ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
SEED = 4321


def _assert_within_one_ulp(name, got, want, terms, value_ulp=True):
    """Every element within one bf16 ulp of want plus one of each of its
    terms (value_ulp False: of the terms alone, for gradients); under 1%
    of the elements differing."""
    diff = np.abs(got - want)
    tol = ULP * ((np.abs(want) if value_ulp else 0.0) + terms) + 1e-6
    assert (diff <= tol).all(), (
        f"{name}: {int((diff > tol).sum())} elements beyond one bf16 ulp of their "
        f"terms; max diff {diff.max():.3e}")
    share = float((diff > 0).mean())
    assert share < 0.01, f"{name}: {100 * share:.3f}% of the elements differ"


def _k3_inputs(seed, B, H, L, Dh):
    """q, k, v, dO [B, H, L, Dh] fp32 from a numpy seed and a [B, L] key
    mask: a suffix of padding in row 0, holes in row 1."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(4))
    j = np.arange(L)
    mask = np.stack([j < (2 * L) // 3, j % 3 != 1])
    return q, k, v, do, mask


# (Dh, L): widths that are no built width (8, 12) and one that is (32);
# L = 600 spans two of the forward's 512-key blocks
K3_CASES = [(8, 130), (12, 600), (32, 130)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,L", K3_CASES)
def test_k3_plain_version_matches_pallas_at_width(Dh, L, dtype):
    q, k, v, do, mask = _k3_inputs(Dh, 2, 2, L, Dh)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)) for t in (tq, tk, tv))
    precision = "highest" if dtype == "float32" else "default"
    rate = 0.5

    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), dropout_rate=rate,
                                  dropout_seed=SEED, interpret=True, precision=precision)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in (jout, *jgrads)]

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    kw = dict(dropout_rate=rate, dropout_seed=SEED)
    out = fa.flash_attention(*leaves, tmask, **kw)           # sm_scale 1/sqrt(Dh)
    (out.float() * tdo).sum().backward()
    got = [x.detach().float().numpy() for x in (out, *(t.grad for t in leaves))]
    assert out.shape == tq.shape and out.dtype == td
    if dtype == "float32":
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        return
    kw["sm_scale"] = 1.0 / Dh ** 0.5
    terms, lse = fa.flash_attention_reference(tq.float(), tk.float(), tv.float().abs(),
                                              tmask, **kw)
    _assert_within_one_ulp("out", got[0], want[0], terms.numpy())
    _, lse = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    g = tdo.bfloat16()
    delta = (g.float() * out.detach().float()).sum(-1)
    grad_terms = fa.flash_attention_grad_terms(tq, tk, tv, tmask, lse, delta, g, **kw)
    for name, gv, w, t in zip(("dq", "dk", "dv"), got[1:], want[1:], grad_terms):
        _assert_within_one_ulp(name, gv, w, t.numpy(), value_ulp=False)


def _segments(L: int) -> np.ndarray:
    """[2, L] int32: runs of 37 with a padding suffix, and three interleaved
    segments broken by padding every 7th position."""
    i = np.arange(L)
    return np.stack([np.where(i < L - 15, i // 37 + 1, 0),
                     np.where(i % 7 == 6, 0, i % 3 + 1)]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nt", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("Dh", [8, 32])
def test_segment_plain_version_matches_pallas_at_width(Dh, nt, dtype):
    B, H, L = 2, 3, 200
    seg = _segments(L)
    rng = np.random.default_rng(Dh)
    shape = (B, L, H, Dh) if nt else (B, H, L, Dh)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(td)
                  for _ in range(3))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)) for t in (tq, tk, tv))
    jfn = jfa.packed_segment_attention_nt if nt else jfa.packed_segment_attention
    fn = fa.packed_segment_attention_nt_reference if nt else fa.packed_segment_attention_reference
    precision = "highest" if dtype == "float32" else "default"
    want = np.asarray(jfn(jq, jk, jv, jnp.asarray(seg), interpret=True,
                          precision=precision).astype(jnp.float32))
    got = fn(tq, tk, tv, torch.from_numpy(seg))
    assert got.dtype == td and got.shape == shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        return
    # sum_j p_j |v_j| / l: the plain version on fp32 copies and |v|
    terms = fn(tq.float(), tk.float(), tv.float().abs(), torch.from_numpy(seg))
    _assert_within_one_ulp("out", got.float().numpy(), want, terms.numpy())


@pytest.mark.parametrize("D", [16, 100])
def test_k1_plain_version_matches_pallas_at_width(D):
    rng = np.random.default_rng(D)
    z = rng.normal(size=(64, D)).astype(np.float32)
    e = rng.normal(size=(300, D)).astype(np.float32)
    jv, ji = vq_pallas.fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=5, tile_n=128,
                                     interpret=True)
    tv, ti = topk_l2.fused_topk_l2_reference(torch.from_numpy(z), torch.from_numpy(e), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------- padding rule --

def _padded(width, *ts):
    return [_build.pad_width(t, width) for t in ts]


@pytest.mark.parametrize("Dh", [1, 8, 12, 100])
def test_k3_padding_rule(Dh):
    width = _build.kernel_width(Dh, "head width")
    q, k, v, do, mask = (torch.from_numpy(x) for x in _k3_inputs(7, 2, 2, 40, Dh))
    kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=0.5, dropout_seed=SEED)
    out, lse = fa.flash_attention_reference(q, k, v, mask, **kw)
    qp, kp, vp, dop = _padded(width, q, k, v, do)
    out_p, lse_p = fa.flash_attention_reference(qp, kp, vp, mask, **kw)
    assert out_p.shape[-1] == width and not out_p[..., Dh:].any()
    torch.testing.assert_close(_build.cut_width(out_p, Dh), out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    delta = (do * out).sum(-1)
    bwd = dict(kw)
    dq = fa.flash_attention_dq_reference(q, k, v, mask, lse, delta, do, **bwd)
    dq_p = fa.flash_attention_dq_reference(qp, kp, vp, mask, lse, delta, dop, **bwd)
    torch.testing.assert_close(_build.cut_width(dq_p, Dh), dq, rtol=1e-6, atol=1e-6)
    for got, want in zip(fa.flash_attention_dkv_reference(qp, kp, vp, mask, lse, delta, dop,
                                                          **bwd),
                         fa.flash_attention_dkv_reference(q, k, v, mask, lse, delta, do,
                                                          **bwd)):
        torch.testing.assert_close(_build.cut_width(got, Dh), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nt", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("Dh", [5, 40])
def test_segment_padding_rule(Dh, nt):
    width = _build.kernel_width(Dh, "head width")
    B, H, L = 2, 3, 150
    seg = torch.from_numpy(_segments(L))
    rng = np.random.default_rng(Dh)
    shape = (B, L, H, Dh) if nt else (B, H, L, Dh)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(3))
    fn = fa.packed_segment_attention_nt_reference if nt else fa.packed_segment_attention_reference
    want = fn(q, k, v, seg)
    got = fn(*_padded(width, q, k, v), seg, sm_scale=1.0 / Dh ** 0.5)
    assert got.shape[-1] == width
    torch.testing.assert_close(_build.cut_width(got, Dh), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("D", [3, 100])
def test_k1_padding_rule(D):
    width = _build.kernel_width(D, "embedding width")
    rng = np.random.default_rng(D)
    z, e = (torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)) for n in (50, 400))
    vals, idx = topk_l2.fused_topk_l2_reference(z, e, 5)
    vals_p, idx_p = topk_l2.fused_topk_l2_reference(*_padded(width, z, e), 5)
    assert torch.equal(idx_p, idx)
    torch.testing.assert_close(vals_p, vals, rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------- shape checks --

def test_kernel_width_rounds_up_to_a_built_width():
    assert [_build.kernel_width(w, "width") for w in (1, 8, 16, 17, 33, 64, 100, 129, 256)] \
        == [16, 16, 16, 32, 64, 64, 128, 256, 256]
    for bad in (0, 257, 512):
        with pytest.raises(ValueError, match="1 to 256"):
            _build.kernel_width(bad, "width")
    x = torch.ones(2, 3)
    assert _build.pad_width(x, 3) is x and _build.cut_width(x, 3) is x
    p = _build.pad_width(x, 16)
    assert p.shape == (2, 16) and p.is_contiguous() and p[:, 3:].eq(0).all()
    assert torch.equal(_build.cut_width(p, 3), x)


def test_k3_check_takes_every_width_to_256():
    """Widths 1-256 run the built kernels (padded up to a built width), any
    wider one the wide route (None)."""
    mask = torch.ones(1, 3, dtype=torch.bool)
    for Dh in range(1, 257):
        q, k = torch.zeros(1, 1, 2, Dh), torch.zeros(1, 1, 3, Dh)
        assert fa._k3_check(q, k, k, mask) == _build.kernel_width(Dh, "head width")
    for Dh in (257, 300, 1000):
        q, k = torch.zeros(1, 1, 2, Dh), torch.zeros(1, 1, 3, Dh)
        assert fa._k3_check(q, k, k, mask) is None


@pytest.mark.parametrize("heads_dim", [1, 2], ids=["K2", "K4"])
def test_segment_check_takes_every_width_to_256(heads_dim):
    """As the K3 test, for K2 and K4: the built kernels to 256, the wide
    route above; the head count comes from the layout either way."""
    seg = torch.ones(2, 5, dtype=torch.int32)
    for Dh in (*range(1, 257), 257, 300):
        shape = [2, 5, Dh]
        shape.insert(heads_dim, 3)
        q = torch.zeros(shape)
        want = _build.kernel_width(Dh, "head width") if Dh <= 256 else None
        assert fa._segment_check(q, q, q, seg, heads_dim) == (3, want)


def test_k1_check_takes_every_width_to_256_and_k_to_8():
    """The 3xTF32 kernel takes D 1-256 with k 1-8; a wider D or a larger k
    takes the wide route (None); k outside [1, N] raises."""
    for D in range(1, 257):
        z, e = torch.zeros(4, D), torch.zeros(10, D)
        assert topk_l2._check(z, e, 5) == _build.kernel_width(D, "embedding width")
    for D in (257, 300):
        assert topk_l2._check(torch.zeros(4, D), torch.zeros(10, D), 5) is None
    for k in (9, 10):
        assert topk_l2._check(torch.zeros(4, 16), torch.zeros(10, 16), k) is None
    for k in (0, 11):
        with pytest.raises(ValueError, match="N=10"):
            topk_l2._check(torch.zeros(4, 16), torch.zeros(10, 16), k)
