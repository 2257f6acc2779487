"""Port vs JAX: flash attention K3 (forward, dq and dk/dv through autograd)
against the Pallas kernels in interpret mode, the dropout hash bit for bit,
the plain versions' batch slices and the dense/flash dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu_torch.ops import flash_attention as fa

# fp32: both sides compute in fp32 and differ only in summation order.
# bf16: both sides round the inputs, the probabilities (forward) and ds /
# the dropped probabilities (backward) to bf16 (8-bit mantissa, relative
# step 2**-8). The plain version rounds the forward's probabilities against
# the running max of 512-key blocks, the TPU kernel's default block_k;
# here the Pallas kernel is called with block_k=32, so that L=67 spans
# three blocks, and rounds against the running max of each 32-key block
# while the plain version's one block uses the row max. So values of order
# 1 differ by a few bf16 steps. At the default blocks the two agree within
# one bf16 ulp of each term (tests/test_torch_flash3_bf16.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B=3, H=2, Lq=67, Lk=67, Dh=16):
    """q, k, v, dO from a numpy seed, and a key mask with ragged lengths,
    one all-masked row and one full row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)
    do = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    lens = np.array([Lk, 0] + list(rng.integers(1, Lk, size=B - 2)))
    mask = np.arange(Lk)[None] < lens[:, None]
    return q, k, v, do, mask


def _jax_side(q, k, v, do, mask, rate, seed, dtype):
    jd = jnp.dtype(dtype)
    args = [jnp.asarray(x).astype(jd) for x in (q, k, v)]

    def loss(q_, k_, v_):
        out = jfa.flash_attention(
            q_, k_, v_, jnp.asarray(mask), dropout_rate=rate, dropout_seed=seed,
            block_q=16, block_k=32, interpret=True,
            precision="highest" if dtype == "float32" else "default")
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_side(q, k, v, do, mask, rate, seed, dtype):
    td = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*args, torch.from_numpy(mask), dropout_rate=rate,
                             dropout_seed=seed)
    assert out.dtype == td
    (out.float() * torch.from_numpy(do)).sum().backward()
    assert all(a.grad.dtype == td for a in args)
    return [x.detach().float().numpy() for x in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_flash_attention_and_grads_match_pallas(dtype, rate):
    q, k, v, do, mask = _inputs(0)
    want = _jax_side(q, k, v, do, mask, rate, 1234, dtype)
    got = _port_side(q, k, v, do, mask, rate, 1234, dtype)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL[dtype], rtol=0, err_msg=name)
    # the all-masked batch row: zero output and zero gradients on both sides
    for g, w in zip(got, want):
        assert not g[1].any() and not w[1].any()
    if rate > 0.0:   # dropout changed the output, so the keep bits matter
        no_drop = _port_side(q, k, v, do, mask, 0.0, 0, dtype)[0]
        assert np.abs(no_drop - got[0]).max() > 10 * TOL[dtype]


def test_cross_lengths_and_lse_match_pallas():
    """Lq != Lk, and the saved lse against the TPU forward's residual."""
    q, k, v, _, mask = _inputs(1, B=2, H=2, Lq=45, Lk=70)
    rate, seed = 0.3, 99
    out, lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), sm_scale=0.25, dropout_rate=rate, dropout_seed=seed)
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    jout, (_, _, _, _, _, jlse, _) = jfa._flash_core_fwd(
        jnp.asarray(q.reshape(B * H, Lq, Dh)), jnp.asarray(k.reshape(B * H, Lk, Dh)),
        jnp.asarray(v.reshape(B * H, Lk, Dh)),
        jnp.asarray(mask.astype(np.int32))[:, None, :], jnp.asarray([seed], jnp.int32),
        H, 0.25, rate, (Lq, Lk), True, jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(B, H, Lq, Dh),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, Lq),
                               atol=1e-5, rtol=1e-6)
    assert (lse.numpy()[1] == -1e30).all()   # the all-masked row's sentinel


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 2, -5])
def test_uniform_hash_bit_identical(seed):
    bq = bk = 8
    for bh, row0, col0 in [(0, 0, 0), (7, 2**31 + 5, 3), (2**20 + 3, 2**32 - 4, 2**31),
                           (1023, 2000, 1990)]:
        want = jfa._uniform_hash(jnp.asarray(seed, jnp.int32), jnp.uint32(bh),
                                 jnp.uint32(row0), jnp.uint32(col0), bq, bk)
        rows = (row0 + torch.arange(bq, dtype=torch.int64)) & 0xFFFFFFFF
        cols = (col0 + torch.arange(bk, dtype=torch.int64)) & 0xFFFFFFFF
        got = fa.uniform_hash(seed, bh, rows[:, None], cols[None, :])
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_auto_takes_flash_on_cuda_only():
    from medtok_tpu_torch.models.layers import MultiheadAttention, resolve_use_flash

    assert resolve_use_flash("auto", "cuda") and resolve_use_flash("auto", "cuda:0")
    assert not resolve_use_flash("auto", "cpu")
    assert resolve_use_flash(True, "cpu") and not resolve_use_flash(False, "cuda")
    with pytest.raises(ValueError, match="use_flash"):
        MultiheadAttention(32, 2, use_flash="dense")
    # on CPU tensors "auto" is the dense path
    torch.manual_seed(0)
    auto = MultiheadAttention(32, 2, use_flash="auto").eval()
    dense = MultiheadAttention(32, 2, use_flash=False).eval()
    dense.load_state_dict(auto.state_dict())
    x = torch.randn(2, 9, 32)
    mask = torch.arange(9)[None] < torch.tensor([[9], [4]])
    assert torch.equal(auto(x, x, x, mask), dense(x, x, x, mask))


def test_flash_dropout_seed_drawn_from_generator():
    """In training the flash path draws its seed as a 0-dim tensor from the
    generator passed in: one generator state gives one dropout mask."""
    from medtok_tpu_torch.models.layers import MultiheadAttention, draw_seed

    torch.manual_seed(1)
    mha = MultiheadAttention(32, 2, dropout=0.5, use_flash=True).train()
    x = torch.randn(2, 9, 32, requires_grad=True)
    mask = torch.arange(9)[None] < torch.tensor([[9], [5]])
    outs = [mha(x, x, x, mask, generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    seed = draw_seed("cpu", torch.Generator().manual_seed(3))
    assert seed.dim() == 0 and seed.dtype == torch.int64
    outs[0].sum().backward()
    assert torch.isfinite(x.grad).all()


def test_plain_versions_slice_with_bh_offset():
    """A slice of batch rows [b0, b1) with bh_offset b0*H gets the dropout
    bits of the whole batch, and a 0-dim tensor seed the bits of its int."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(3, B=4, Lq=30, Lk=30))
    H = q.shape[1]
    kw = dict(sm_scale=0.25, dropout_rate=0.5, dropout_seed=77)
    out, lse = fa.flash_attention_reference(q, k, v, mask, **kw)
    delta = (do * out).sum(-1)
    dq = fa.flash_attention_dq_reference(q, k, v, mask, lse, delta, do, **kw)
    dk, dv = fa.flash_attention_dkv_reference(q, k, v, mask, lse, delta, do, **kw)
    for b0, b1 in ((0, 1), (1, 4), (2, 3)):
        part = [t[b0:b1] for t in (q, k, v, mask, lse, delta, do)]
        o, l = fa.flash_attention_reference(*part[:4], **kw, bh_offset=b0 * H)
        np.testing.assert_allclose(o.numpy(), out[b0:b1].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(l.numpy(), lse[b0:b1].numpy(), atol=1e-6, rtol=0)
        g = fa.flash_attention_dq_reference(*part, **kw, bh_offset=b0 * H)
        np.testing.assert_allclose(g.numpy(), dq[b0:b1].numpy(), atol=1e-6, rtol=0)
        gk, gv = fa.flash_attention_dkv_reference(*part, **kw, bh_offset=b0 * H)
        np.testing.assert_allclose(gk.numpy(), dk[b0:b1].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(gv.numpy(), dv[b0:b1].numpy(), atol=1e-6, rtol=0)
    # without the offset a slice past row 0 gets other bits
    o, _ = fa.flash_attention_reference(*(t[1:] for t in (q, k, v, mask)), **kw)
    assert np.abs(o.numpy() - out[1:].numpy()).max() > 1e-3
    seeded = fa.flash_attention(q, k, v, mask, sm_scale=0.25, dropout_rate=0.5,
                                dropout_seed=torch.tensor(77))
    assert torch.equal(seeded, out)


def test_wrappers_run_plain_versions_on_cpu():
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(2, B=2, Lq=20, Lk=20))
    counts = [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_dq,
                                   fa.flash_attention_dkv)]
    kw = dict(sm_scale=0.3, dropout_rate=0.5, dropout_seed=5)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = (do * out).sum(-1)
    assert torch.equal(fa.flash_attention_dq(q, k, v, mask, lse, delta, do, **kw),
                       fa.flash_attention_dq_reference(q, k, v, mask, lse, delta, do, **kw))
    dk, dv = fa.flash_attention_dkv(q, k, v, mask, lse, delta, do, **kw)
    rdk, rdv = fa.flash_attention_dkv_reference(q, k, v, mask, lse, delta, do, **kw)
    assert torch.equal(dk, rdk) and torch.equal(dv, rdv)
    assert counts == [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_dq,
                                           fa.flash_attention_dkv)]
    meta = [t.to("meta") for t in (q, k, v, mask)]
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(*meta, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*meta)
