"""The training objective's pieces against the JAX package on the CPU: each
loss function, the train branch of the soft top-k quantizer with its
gradients (and the straight-through form's witness), and the usage FIFO
over index batches that wrap its buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import vq as jax_vq
from medtok_tpu.train import losses as jax_losses
from medtok_tpu_torch.ops import vq
from medtok_tpu_torch.train import losses

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert got == pytest.approx(want, rel=rtol, abs=1e-7), (got, want)


def _rows(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", ["info_nce_loss", "alignment_loss", "orthogonal_loss"])
def test_pair_losses_match_jax(name):
    a, b = _rows(0, (16, 32), (16, 32))
    _close(getattr(losses, name)(_t(a), _t(b)),
           getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b)))


def test_shared_and_specific_losses_match_jax():
    z1, z2, x1, x2, z1a, z2a = _rows(1, *[(12, 16)] * 6)
    got = losses.shared_loss(*map(_t, (z1, z2, x1, x2)))
    want = jax_losses.shared_loss(*map(jnp.asarray, (z1, z2, x1, x2)))
    for g, w in zip(got, want):
        _close(g, w)
    # bf16 shared embeddings, as the quantizer returns them, against fp32 rows
    z2c = torch.from_numpy(z2).to(torch.bfloat16)
    args = (_t(z1), _t(z1a), _t(x1), _t(z2a), _t(x2), z2c)
    jargs = (jnp.asarray(z1), jnp.asarray(z1a), jnp.asarray(x1), jnp.asarray(z2a),
             jnp.asarray(x2), jnp.asarray(z2, jnp.bfloat16))
    for g, w in zip(losses.specific_loss(*args), jax_losses.specific_loss(*jargs)):
        _close(g, w)


def test_entropy_loss_matches_jax():
    (aff,) = _rows(2, (2, 10, 90))
    _close(losses.compute_entropy_loss(_t(aff)),
           jax_losses.compute_entropy_loss(jnp.asarray(aff)), rtol=1e-5)


def test_assemble_losses_matches_jax():
    """The total and the 22 metrics from one result dict, with the entropy
    term on."""
    rng = np.random.default_rng(3)
    B, D = 8, 16

    def r(*s):
        return rng.normal(size=s).astype(np.float32)

    arrays = {k: r(B, D) for k in (
        "graph_feature", "text_feature", "shared_text_embedding",
        "shared_graph_embedding", "specific_embedding_text",
        "specific_embedding_graph", "specific_embedding_text_aug",
        "specific_embedding_graph_aug")}
    arrays["shared_affinity"] = r(2 * B, 90)
    scalars = {k: tuple(abs(r()) for _ in range(2)) for k in (
        "shared_embed_loss", "text_specific_loss", "graph_specific_loss")}
    usage = {k: abs(r()) for k in ("shared_codebook_usage", "text_specific_usage",
                                   "graph_specific_usage")}

    def build(conv):
        qr = {k: conv(v) for k, v in {**arrays, **usage}.items()}
        qr.update({k: tuple(conv(x) for x in v) for k, v in scalars.items()})
        return qr

    kw = dict(shared_loss_beta=0.1, specific_loss_lamb=0.1, entropy_loss_ratio=0.5)
    got = losses.assemble_losses(build(_t), **kw)
    want = jax_losses.assemble_losses(build(jnp.asarray), **kw)
    assert set(got.metrics) == set(want.metrics) and len(got.metrics) == 22
    _close(got.total, want.total, rtol=1e-5)
    for k, w in want.metrics.items():
        _close(got.metrics[k], w, rtol=1e-5)


def _quantize_case(region):
    rng = np.random.default_rng(4)
    z = rng.normal(size=(12, 16)).astype(np.float32)
    cb = rng.normal(size=(90, 16)).astype(np.float32)
    c = rng.normal(size=(12, 16)).astype(np.float32)      # a cotangent for z_q
    cw = rng.normal(size=(12, 5)).astype(np.float32)      # and for the weights
    return z, cb, c, cw


@pytest.mark.parametrize("region", [None, "text", "graph"])
def test_soft_topk_quantize_train_matches_jax_grad(region):
    """z_q, z_q_raw, the vq and commit losses, and the gradients of a loss
    that reaches z_q, the weights and both losses, with respect to z and the
    codebook, against ``jax.grad``; within 1e-5 of each one's largest."""
    z, cb, c, cw = _quantize_case(region)

    def jax_loss(z_, cb_):
        cbr = cb_ if region is None else jax_vq.region_slice(cb_, region)
        q = jax_vq.soft_topk_quantize(z_, cbr, k=5, beta=0.25, train=True)
        return (q.vq_loss + q.commit_loss + jnp.sum(q.z_q * c)
                + jnp.sum(q.weights * cw)), q

    (_, jq), (jgz, jgc) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(cb))
    zt, cbt = _t(z).requires_grad_(), _t(cb).requires_grad_()
    q = vq.soft_topk_quantize(zt, cbt, k=5, beta=0.25, train=True, region=region)
    (q.vq_loss + q.commit_loss + (q.z_q * _t(c)).sum() + (q.weights * _t(cw)).sum()).backward()

    np.testing.assert_array_equal(q.indices.numpy(), np.asarray(jq.indices))
    for got, want in ((q.z_q, jq.z_q), (q.z_q_raw, jq.z_q_raw), (q.weights, jq.weights),
                      (zt.grad, jgz), (cbt.grad, jgc)):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, err
    _close(q.vq_loss, jq.vq_loss, rtol=1e-5)
    _close(q.commit_loss, jq.commit_loss, rtol=1e-5)


def test_straight_through_gradient_reaches_z_only():
    """The witness of the straight-through repair: the gradient of a loss on
    z_q reaches z as the identity and never the codebook. The form without
    the stop-gradient, z + (z_q_raw - z), lets it reach the codebook."""
    z, cb, c, _ = _quantize_case(None)
    zt, cbt = _t(z).requires_grad_(), _t(cb).requires_grad_()
    q = vq.soft_topk_quantize(zt, cbt, k=5, train=True)
    (q.z_q * _t(c)).sum().backward()
    assert cbt.grad is None or not cbt.grad.any()
    np.testing.assert_array_equal(zt.grad.numpy(), c)

    zt, cbt = _t(z).requires_grad_(), _t(cb).requires_grad_()
    q = vq.soft_topk_quantize(zt, cbt, k=5, train=True)
    unrepaired = zt + (q.z_q_raw - zt)
    (unrepaired * _t(c)).sum().backward()
    assert cbt.grad.abs().max() > 1e-3


def test_eval_quantize_takes_no_losses():
    z, cb, _, _ = _quantize_case(None)
    q = vq.soft_topk_quantize(_t(z), _t(cb), k=5)
    assert q.vq_loss is None and q.commit_loss is None
    np.testing.assert_allclose(q.z_q.numpy(), q.z_q_raw.numpy(), atol=1e-6, rtol=0)


def test_usage_update_matches_jax_over_a_wrapping_buffer():
    """Index batches that fill the FIFO and wrap it several times, ids
    outside [0, n_e) among them (-1 counts from the end; n_e, n_e + 5 and
    -n_e - 1 are dropped, as the JAX scatter's mode="drop" drops them):
    buffer, counts and usage equal JAX's exactly after every batch."""
    n_e, size = 20, 37
    rng = np.random.default_rng(5)
    buf, counts = torch.zeros(size, dtype=torch.int32), vq.usage_counts_init(n_e, size)
    jbuf, jcounts = jnp.zeros(size, jnp.int32), jax_vq.usage_counts_init(n_e, size)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    for step in range(12):
        idx = rng.integers(0, n_e, size=(3, 5)).astype(np.int32)
        if step == 4:
            idx[0, :4] = (-1, n_e, n_e + 5, -n_e - 1)
        buf, counts, usage = vq.usage_update(buf, counts, _t(idx), n_e)
        jbuf, jcounts, jusage = jax_vq.usage_update(jbuf, jcounts, jnp.asarray(idx), n_e)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert float(usage) == float(jusage)
    assert step * 15 > 3 * size
