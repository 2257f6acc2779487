"""The tensor-parallel codebook sweep: ``ops.vq.distance_topk_tp`` over two
and four gloo ranks of the port on the CPU (meshes dp 2 x tp 2 and dp 1 x
tp 4 over one world of four) against JAX ``shard_map(vq.distance_topk_tp)``
on a (1, tp) mesh of virtual CPU devices, on the same numpy inputs
(``tests/test_tp.py``'s shapes): indices equal, values within 1e-5.

The cases: the whole codebook; the graph region [16, 24) of 24 rows, which
no row of rank 0's block meets at tp 2 (the rank launches nothing and
joins the gather with +inf candidates) and only 2 < k rows of rank 2's at
tp 4; the text region [0, 8); and a codebook whose second half repeats its
first, so every distance ties across ranks and the lower global index
wins. ``soft_topk_quantize`` through the tp route (each region by name)
gives the one-device port's indices, weights, output and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from medtok_tpu.ops import vq as jvq
from medtok_tpu_torch.ops import vq
from tests.torch_dp_ranks import spawn_ranks

WORLD, TPS = 4, (2, 4)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _cases():
    rng = np.random.default_rng(0)
    tied = _unit(rng, 12, 4)
    return [
        (_unit(rng, 16, 8), _unit(rng, 64, 8), 5, None),
        (_unit(rng, 8, 4), _unit(rng, 24, 4), 3, (16, 24)),
        (_unit(rng, 8, 4), _unit(rng, 24, 4), 3, (0, 8)),
        (_unit(rng, 8, 4), np.concatenate([tied, tied]), 4, None),
    ]


def _quantize_cases():
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(6, 8)).astype(np.float32),
             rng.normal(size=(48, 8)).astype(np.float32), 5, region)
            for region in (None, "text", "graph")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spec = dict(tps=TPS, cases=_cases(), quantize=_quantize_cases())
    return spawn_ranks("tp_sweep", WORLD, tmp_path_factory.mktemp("tp_sweep"), spec)


def _jax_sweep(z, e, k, region, tp):
    mesh = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    f = jax.jit(jax.shard_map(
        lambda z, e: jvq.distance_topk_tp(z, e, k, "tp", region=region),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))
    vals, idx = f(jnp.asarray(z), jnp.asarray(e))
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("tp", TPS)
def test_sweep_matches_jax_shard_map(ranks, tp):
    for c, (z, e, k, region) in enumerate(_cases()):
        want_v, want_i = _jax_sweep(z, e, k, region, tp)
        for r in ranks:
            v, i = r[tp]["sweeps"][c]
            np.testing.assert_array_equal(i, want_i, err_msg=f"case {c}")
            np.testing.assert_allclose(v, want_v, rtol=0, atol=1e-5, err_msg=f"case {c}")
        lo = 0 if region is None else region[0]
        hi = e.shape[0] if region is None else region[1]
        d = ((z[:, None, :] - e[None, lo:hi, :]) ** 2).sum(-1)
        want = np.argsort(d, axis=1, kind="stable")[:, :k] + lo   # ties to the lower id
        np.testing.assert_array_equal(ranks[0][tp]["sweeps"][c][1], want, err_msg=f"case {c}")


@pytest.mark.parametrize("tp", TPS)
def test_the_tp_ranks_agree_bitwise(ranks, tp):
    assert sorted(r[tp]["tp_index"] for r in ranks) == sorted(list(range(tp)) * (WORLD // tp))
    for r in ranks[1:]:
        for (v, i), (v0, i0) in zip(r[tp]["sweeps"], ranks[0][tp]["sweeps"]):
            assert np.array_equal(v, v0) and np.array_equal(i, i0)


@pytest.mark.parametrize("tp", TPS)
def test_quantize_through_the_tp_route_is_the_one_device_one(ranks, tp):
    for c, (z, e, k, region) in enumerate(_quantize_cases()):
        zt = torch.from_numpy(z).requires_grad_()
        et = torch.from_numpy(e).requires_grad_()
        q = vq.soft_topk_quantize(zt, et, k=k, train=True, region=region)
        (q.z_q_raw.square().sum() + q.vq_loss + q.commit_loss).backward()
        got = ranks[0][tp]["quantize"][c]
        np.testing.assert_array_equal(got["indices"], q.indices.numpy(), err_msg=f"{c}")
        for name, want in (("weights", q.weights), ("z_q", q.z_q), ("dz", zt.grad),
                           ("de", et.grad)):
            np.testing.assert_allclose(got[name], want.detach().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{c} {name}")


def test_refusals():
    from medtok_tpu_torch.parallel.mesh import DataParallel

    mesh = DataParallel(0, 4, torch.device("cpu"), tp_size=4)
    z, e = torch.zeros(2, 4), torch.zeros(30, 4)
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        vq.distance_topk_tp(z, e, 3, mesh)
    with pytest.raises(ValueError, match="fewer than k=3"):
        vq.distance_topk_tp(z, torch.zeros(32, 4), 3, mesh, region=(0, 2))
