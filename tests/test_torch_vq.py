"""Port vs JAX: the top-k codebook sweep (plain version of kernel K1) and the
eval soft top-k quantizer. Inputs are made with numpy from a seed and fed to
both sides; the JAX Pallas kernel runs in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medtok_tpu.ops import vq as jvq
from medtok_tpu.ops.vq_pallas import fused_topk_l2 as jax_fused_topk_l2
from medtok_tpu_torch.ops import vq
from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2, fused_topk_l2_reference


def _normalized(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_topk_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    z, e = _normalized(rng, 37, 64), _normalized(rng, 300, 64)
    jv, ji = jax_fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=5, tile_b=8,
                               tile_n=128, interpret=True)
    launches = fused_topk_l2.launches
    tv, ti = fused_topk_l2(torch.from_numpy(z), torch.from_numpy(e), k=5)
    assert fused_topk_l2.launches == launches  # CPU tensors: no kernel launch
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_topk_tie_break_lowest_index():
    # duplicated codewords give exact distance ties -> lowest index first
    rng = np.random.default_rng(1)
    base = rng.normal(size=(64, 16)).astype(np.float32)
    e = np.concatenate([base, base], axis=0)
    z = rng.normal(size=(4, 16)).astype(np.float32)
    _, ji = jax_fused_topk_l2(jnp.asarray(z), jnp.asarray(e), k=5, tile_b=8,
                              tile_n=64, interpret=True)
    _, ref_i = jvq.topk_smallest(jvq.squared_distance(jnp.asarray(z), jnp.asarray(e)), 5)
    _, ti = fused_topk_l2_reference(torch.from_numpy(z), torch.from_numpy(e), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ref_i))
    assert (ti[:, 1] == ti[:, 0] + 64).all()  # the lower copy ranks first


@pytest.mark.parametrize("region", [None, "text", "graph"])
def test_soft_topk_quantize_eval_matches_jax(region):
    rng = np.random.default_rng(2)
    z = rng.normal(size=(24, 16)).astype(np.float32)
    cb = rng.normal(size=(90, 16)).astype(np.float32)
    jcb = jvq.region_slice(jnp.asarray(cb), region or "full")
    jq = jvq.soft_topk_quantize(jnp.asarray(z), jcb, k=5, train=False,
                                backend="xla")
    tq = vq.soft_topk_quantize(torch.from_numpy(z), torch.from_numpy(cb), k=5,
                               region=region)
    np.testing.assert_array_equal(tq.indices.numpy(), np.asarray(jq.indices))
    np.testing.assert_allclose(tq.weights.numpy(), np.asarray(jq.weights),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tq.z_q.numpy(), np.asarray(jq.z_q), atol=1e-6, rtol=0)


def test_distance_topk_every_backend_runs_plain_on_cpu():
    rng = np.random.default_rng(3)
    z, e = (torch.from_numpy(_normalized(rng, 9, 16)),
            torch.from_numpy(_normalized(rng, 50, 16)))
    ref_v, ref_i = vq.topk_smallest(vq.squared_distance(z, e), 5)
    for backend in vq.TOPK_BACKENDS:
        v, i = vq.distance_topk(z, e, 5, backend=backend)
        assert torch.equal(i, ref_i) and torch.equal(v, ref_v)
    with pytest.raises(ValueError, match="topk_backend"):
        vq.distance_topk(z, e, 5, backend="approx")


def test_region_slice_is_a_view():
    cb = torch.arange(90 * 4, dtype=torch.float32).reshape(90, 4)
    for region, lo in (("text", 0), ("graph", 60)):
        r = vq.region_slice(cb, region)
        assert r.shape == (30, 4) and r.is_contiguous()
        assert r.data_ptr() == cb.data_ptr() + lo * 4 * cb.element_size()
    with pytest.raises(ValueError):
        vq.region_slice(cb, "audio")


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    # a tensor that is neither on the CPU nor on CUDA must not be served by
    # the plain version
    z = torch.empty((4, 64), device="meta")
    e = torch.empty((32, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_topk_l2(z, e, k=5)
