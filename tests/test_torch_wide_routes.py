"""Port vs JAX at the widths and k that take the kernels' wide routes: head
widths above 256 for K2 / K4 / K3, embedding widths above 256 or k above 8
for K1. On the card those shapes launch the wide kernels, which are held to
these plain versions there (chip_smoke.py's width phase); here, on the CPU:

- K1's plain version against the Pallas kernel in interpret mode at D = 257
  and 320, k = 9 and 16: indices equal, values within 1e-5 relative; exact
  ties (every codeword twice) ranked lowest index first at k = 16;
- K2 / K4 and K3 (out, and dq / dk / dv through autograd, dropout 0.5)
  against the Pallas kernels in interpret mode at Dh = 257 and 320: fp32
  within 1e-5 of the largest element, bf16 at precision 'default' within
  one bf16 ulp of each term (the rule of tests/test_torch_segment_bf16.py
  and tests/test_torch_flash3_bf16.py) with under 1% of the elements
  differing;
- the wrappers on CPU tensors take those shapes and return the plain
  versions' results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu.ops import vq_pallas
from medtok_tpu_torch.ops import flash_attention as fa
from medtok_tpu_torch.ops import topk_l2

ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
SEED = 9127
WIDE = (257, 320)


def _assert_fp32_close(name, got, want):
    """Within 1e-5 of the largest element of want."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), f"{name}: max error {err:.3e}"


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


# --------------------------------------------------------------------- K1 --

@pytest.mark.parametrize("k", [9, 16])
@pytest.mark.parametrize("D", WIDE)
def test_k1_plain_version_matches_pallas_wide(D, k):
    rng = np.random.default_rng(D + k)
    z = rng.normal(size=(40, D)).astype(np.float32)
    e = rng.normal(size=(300, D)).astype(np.float32)
    jv, ji = vq_pallas.fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=k, tile_n=128,
                                     interpret=True)
    tv, ti = topk_l2.fused_topk_l2(torch.from_numpy(z), torch.from_numpy(e), k=k)
    assert tv.shape == ti.shape == (40, k) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=0)


def test_k1_plain_version_ranks_exact_ties_lowest_first_wide():
    rng = np.random.default_rng(SEED)
    base = rng.normal(size=(60, 320)).astype(np.float32)
    e = np.concatenate([base, base])
    z = rng.normal(size=(16, 320)).astype(np.float32)
    jv, ji = vq_pallas.fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=16, tile_n=128,
                                     interpret=True)
    tv, ti = topk_l2.fused_topk_l2(torch.from_numpy(z), torch.from_numpy(e), k=16)
    ti = ti.numpy()
    np.testing.assert_array_equal(ti, np.asarray(ji))
    # each codeword and its copy side by side, the lower index first
    assert (ti[:, 1::2] == ti[:, 0::2] + 60).all() and (ti[:, 0::2] < 60).all()
    assert (tv[:, 0::2] == tv[:, 1::2]).all()


# --------------------------------------------------------------- K2 / K4 --

def _segments(L: int) -> np.ndarray:
    """[2, L] int32: runs of 37 with a padding suffix, and three interleaved
    segments broken by padding every 7th position."""
    i = np.arange(L)
    return np.stack([np.where(i < L - 15, i // 37 + 1, 0),
                     np.where(i % 7 == 6, 0, i % 3 + 1)]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nt", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("Dh", WIDE)
def test_segment_plain_version_matches_pallas_wide(Dh, nt, dtype):
    B, H, L = 2, 2, 200
    seg = _segments(L)
    rng = np.random.default_rng(Dh + nt)
    shape = (B, L, H, Dh) if nt else (B, H, L, Dh)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(td)
                  for _ in range(3))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)) for t in (tq, tk, tv))
    jfn = jfa.packed_segment_attention_nt if nt else jfa.packed_segment_attention
    fn = fa.packed_segment_attention_nt if nt else fa.packed_segment_attention
    plain = fa.packed_segment_attention_nt_reference if nt else \
        fa.packed_segment_attention_reference
    precision = "highest" if dtype == "float32" else "default"
    want = np.asarray(jfn(jq, jk, jv, jnp.asarray(seg), interpret=True,
                          precision=precision).astype(jnp.float32))
    got = fn(tq, tk, tv, torch.from_numpy(seg))      # the wrapper, on the CPU
    assert got.dtype == td and got.shape == shape
    assert torch.equal(got, plain(tq, tk, tv, torch.from_numpy(seg)))
    if dtype == "float32":
        _assert_fp32_close("out", got.numpy(), want)
        return
    # sum_j p_j |v_j| / l: the plain version on fp32 copies and |v|
    terms = plain(tq.float(), tk.float(), tv.float().abs(), torch.from_numpy(seg))
    _assert_within_one_ulp("out", got.float().numpy(), want, terms.numpy())


# --------------------------------------------------------------------- K3 --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,L", [(257, 130), (320, 600)])
def test_k3_plain_version_matches_pallas_wide(Dh, L, dtype):
    """L = 600 spans two of the forward's 512-key blocks."""
    B, H = 2, 2
    rng = np.random.default_rng(Dh)
    q, k, v, do = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(4))
    j = np.arange(L)
    mask = np.stack([j < (2 * L) // 3, j % 3 != 1])
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
            _assert_fp32_close(name, g, w)
        return
    kw["sm_scale"] = 1.0 / Dh ** 0.5
    terms, _ = fa.flash_attention_reference(tq.float(), tk.float(), tv.float().abs(),
                                            tmask, **kw)
    _assert_within_one_ulp("out", got[0], want[0], terms.numpy())
    _, lse = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    g = tdo.bfloat16()
    delta = (g.float() * out.detach().float()).sum(-1)
    grad_terms = fa.flash_attention_grad_terms(tq, tk, tv, tmask, lse, delta, g, **kw)
    for name, gv, w, t in zip(("dq", "dk", "dv"), got[1:], want[1:], grad_terms):
        _assert_within_one_ulp(name, gv, w, t.numpy(), value_ulp=False)


# ---------------------------------------------------------- dkv's splits --

@pytest.mark.parametrize("key_blocks,groups,sms", [
    (144, 35, 132),     # chip_smoke.py's timing shape: 3 splits of 12 groups
    (54, 10, 132),      # 9 splits fit; 10 groups make 5 splits of 2
    (30, 10, 132),      # more splits fit than groups: one group a split
    (1024 * 16, 63, 132),  # enough key blocks: one split
    (1, 1, 132),
])
def test_dkv_wide_splits_cover_every_query_group_once(key_blocks, groups, sms):
    splits, per = fa.dkv_wide_splits(key_blocks, groups, sms)
    # the C entry's count from the groups a split
    assert splits == -(-groups // per)
    runs = [range(z * per, min(groups, (z + 1) * per)) for z in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [g for r in runs for g in r] == list(range(groups))
    # one wave of four blocks an SM
    assert splits == 1 or key_blocks * splits <= 4 * sms
