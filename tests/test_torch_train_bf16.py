"""Tokenizer training at bf16 compute: the port's ``_loss_fn`` metrics and
gradients against the JAX package's, on the unpacked and the packed text
route, at tolerances stated in bf16 ulps.

The JAX side runs op by op (``jax.value_and_grad`` without ``jit``), as the
port does. Its jitted program fuses across layers and rounds bf16 at other
points: on this input the jitted loss is 4.8% from the op-by-op one,
because token picks flip at distance ties that 8-bit activations cannot
resolve, so neither execution is a closer reference than the other. The
port against the op-by-op JAX: no token pick differs, the metrics agree
within 1e-3 relative and the gradients within 1.9e-2 of each one's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.train.trainer import _loss_fn as jax_loss_fn
from medtok_tpu_torch.train.trainer import _loss_fn
from tests.test_torch_train_step import (
    assert_grads_match,
    host_batch,
    jax_config,
    jax_state,
    port_config,
    port_inputs,
    port_state,
)

BF16_ULP = 2.0 ** -7    # bf16 keeps 8 significant bits
# a metric sums rounded terms, so it is held to one ulp of its value; a
# gradient sums products of bf16 activations and bf16 cotangents rounded at
# every layer on the way back through two cross-attention layers and the
# GCN, so it is held to four ulps of its largest element. The key bias's
# exact gradient is 0: it is noise within one ulp of the key weight's.
METRIC_RTOL = BF16_ULP
GRAD_TOL = 4 * BF16_ULP
ZERO_TOL = BF16_ULP


@pytest.fixture(scope="module")
def bf16_setup():
    jcfg = jax_config("bfloat16")
    jmodel = JaxTokenizer(jcfg.model)
    batch, packed = host_batch()
    return jcfg, jmodel, batch, packed, jax_state(jcfg, jmodel, batch)


@pytest.mark.parametrize("route", ["unpacked", "packed"])
def test_loss_fn_matches_jax_bf16(bf16_setup, route):
    jcfg, jmodel, batch, packed, jstate = bf16_setup
    jpacked = jax.tree.map(jnp.asarray, packed) if route == "packed" else None
    (_, (want, want_usage)), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jstate.params, jstate.usage, jmodel, jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(3), jcfg, jpacked)

    cfg = port_config(jcfg)
    state = port_state(cfg, jstate)
    model = state.model.train()
    assert model.text_mapped.weight.dtype == torch.float32
    assert model.text_mapped.compute_dtype == torch.bfloat16
    tbatch, tpacked = port_inputs(batch, packed, route)
    loss, got = _loss_fn(model, tbatch, cfg, packed=tpacked)
    loss.backward()
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(
            float(w), rel=METRIC_RTOL, abs=1e-6), k
    assert_grads_match(model, jgrads, tol=GRAD_TOL, zero_tol=ZERO_TOL)
    # no token pick differs on this input
    np.testing.assert_array_equal(model.quantize.codebook_used.numpy(),
                                  np.asarray(want_usage["quantize"]["codebook_used"]))
