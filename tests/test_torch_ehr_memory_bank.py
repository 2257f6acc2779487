"""The port's patient-embedding memory bank and contrastive loss against
the JAX package's on the CPU, within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medtok_tpu.ehr.memory_bank as jmb
import medtok_tpu_torch.ehr.memory_bank as tmb


def _bank_pair(size, dim, batches, seed):
    rng = np.random.default_rng(seed)
    js, ts = jmb.init_memory_bank(size, dim), tmb.init_memory_bank(size, dim)
    for b in batches:
        x = rng.standard_normal((b, dim)).astype(np.float32)
        js = jmb.update_memory_bank(js, jnp.asarray(x))
        ts = tmb.update_memory_bank(ts, torch.from_numpy(x))
    return js, ts


@pytest.mark.parametrize("size,batches", [(8, [3]), (8, [3, 4, 5]), (6, [10]), (5, [5, 5, 2])])
def test_update_and_valid_mask_match_jax(size, batches):
    js, ts = _bank_pair(size, 16, batches, seed=size)
    np.testing.assert_allclose(ts.buffer.numpy(), np.asarray(js.buffer), atol=1e-6, rtol=0)
    assert int(ts.count) == int(js.count) == sum(min(b, size) for b in batches)
    assert ts.count.dtype == torch.int32
    np.testing.assert_array_equal(tmb.bank_valid_mask(ts).numpy(),
                                  np.asarray(jmb.bank_valid_mask(js)))


@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("with_bank", [False, True])
def test_contrastive_loss_matches_jax(with_pos, with_bank):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 16)).astype(np.float32)
    p = rng.standard_normal((7, 16)).astype(np.float32) if with_pos else None
    js, ts = _bank_pair(12, 16, [5], seed=4) if with_bank else (None, None)
    want = jmb.contrastive_loss(jnp.asarray(a), None if p is None else jnp.asarray(p), js,
                                temperature=0.1)
    anchor = torch.from_numpy(a).requires_grad_(True)
    got = tmb.contrastive_loss(anchor, None if p is None else torch.from_numpy(p), ts,
                               temperature=0.1)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    got.backward()   # the bank is detached; the anchor gets a gradient
    assert torch.isfinite(anchor.grad).all()


def test_drop_diagonal_matches_jax():
    x = np.arange(25, dtype=np.float32).reshape(5, 5)
    np.testing.assert_array_equal(tmb._drop_diagonal(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmb._drop_diagonal(jnp.asarray(x))))
