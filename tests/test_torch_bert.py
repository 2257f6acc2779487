"""Port vs JAX: the packed BERT encoder (fp32, weights through convert.py)
and the bf16 gelu fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import TextEncoderConfig as JaxTextConfig
from medtok_tpu.models.bert import BertEncoder as JaxBert
from medtok_tpu.ops.gelu import gelu_bf16 as jax_gelu_bf16
from medtok_tpu_torch.config import TextEncoderConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.data.packing import derive_packed_meta, pack_store_meta
from medtok_tpu_torch.models.bert import BertEncoder
from medtok_tpu_torch.ops.gelu import bert_gelu, gelu_bf16

TINY = dict(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64)


def _packed_rows(rng, rows=4, row_len=32):
    lens = rng.integers(2, 12, size=40).astype(np.int32)
    arena = rng.integers(1, TINY["vocab_size"], size=int(lens.sum())).astype(np.int32)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    n = int(np.searchsorted(np.cumsum(lens), (rows - 1) * row_len))
    ids, base, tl = pack_store_meta(arena, start, lens, np.arange(n),
                                    row_len=row_len, num_rows=rows)
    seg, pos, _, _ = derive_packed_meta(torch.from_numpy(base), torch.from_numpy(tl),
                                        num_rows=rows, row_len=row_len, lmax=1)
    return ids, seg.numpy(), pos.numpy()


@pytest.mark.parametrize("packed", [True, False])
def test_bert_matches_jax(packed):
    rng = np.random.default_rng(0)
    ids, seg, pos = _packed_rows(rng)
    jmodel = JaxBert(JaxTextConfig(**TINY), dtype=jnp.float32)
    if packed:   # segment ids: K2 on the port, the Pallas kernel on JAX
        kw_j = dict(attention_mask=None, position_ids=jnp.asarray(pos),
                    segments=jnp.asarray(seg))
        kw_t = dict(attention_mask=None, position_ids=torch.from_numpy(pos),
                    segments=torch.from_numpy(seg))
    else:        # unpacked rows with a key-padding mask: the dense path
        mask = (seg > 0).astype(np.int32)
        kw_j = dict(attention_mask=jnp.asarray(mask))
        kw_t = dict(attention_mask=torch.from_numpy(mask))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), **kw_j)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), **kw_j))

    model = BertEncoder(TextEncoderConfig(**TINY), dtype=torch.float32)
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), **kw_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_gelu_fit_matches_jax():
    x = np.linspace(-9.0, 4.0, 4001, dtype=np.float32)
    # fp32 evaluation of the fit: same polynomial, same thresholds
    np.testing.assert_allclose(gelu_bf16(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu_bf16(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    # bf16 activations: the same bf16 value, or one ulp off where the two
    # frameworks' fp32 sigmoids round to opposite sides of a bf16 boundary
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = gelu_bf16(xb).float().numpy()
    want = np.asarray(jax_gelu_bf16(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    ulp = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    assert (np.abs(got - want) <= ulp).all()
    assert np.mean(got == want) > 0.99
    assert bert_gelu(xb).dtype == torch.bfloat16
    # fp32 keeps the exact erf gelu
    np.testing.assert_allclose(bert_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=1e-6, rtol=0)
