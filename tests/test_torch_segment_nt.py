"""Port vs JAX: kernel K4 (packed segment attention in the [B, L, H, Dh]
layout) against the Pallas kernel in interpret mode, encode_text_packed
with a pairwise mask against the JAX method, and the port's packed-BERT
probe (scripts/profile_bert.py) on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.data.synthetic import random_code_batch
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.ops.flash_attention import packed_segment_attention_nt as jax_psa_nt
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import flax_params_to_state_dict
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.ops.flash_attention import (
    packed_segment_attention_nt,
    packed_segment_attention_nt_reference,
    packed_segment_attention_reference,
)
from medtok_tpu_torch.scripts import profile_bert
from tests.test_model import tiny_config


def _segments(B: int, L: int) -> np.ndarray:
    """The JAX test's layout (tests/test_flash_attention.py): two segments
    in row 0, one in row 1, padding after them."""
    seg = np.zeros((B, L), np.int32)
    seg[0, :7], seg[0, 7:30], seg[1, :20] = 1, 2, 1
    return seg


@pytest.mark.parametrize("sm_scale", [None, 0.3])
def test_nt_reference_matches_pallas_kernel(sm_scale):
    # the JAX test's shape [2, 40, 3, 16] in [B, L, H, Dh], blocks of 16 so
    # the kernel's online softmax carries over three key blocks
    rng = np.random.default_rng(13)
    B, L, H, Dh = 2, 40, 3, 16
    q, k, v = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(3))
    seg = _segments(B, L)
    want = np.asarray(jax_psa_nt(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(seg), sm_scale=sm_scale, block_q=16,
                                 block_k=16, interpret=True, precision="highest"))
    tq, tk, tv, ts = map(torch.from_numpy, (q, k, v, seg))
    got = packed_segment_attention_nt_reference(tq, tk, tv, ts, sm_scale=sm_scale)
    assert got.shape == (B, L, H, Dh) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # all-padding query rows are exactly zero
    assert (got.numpy()[seg == 0] == 0).all()
    # K2's plain version on the [B, H, L, Dh] inputs gives the same numbers
    k2 = packed_segment_attention_reference(
        *(t.transpose(1, 2).contiguous() for t in (tq, tk, tv)), ts, sm_scale=sm_scale)
    assert torch.equal(k2.transpose(1, 2), got)


def test_nt_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(_segments(2, 40))
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 40, 3, 64)).astype(np.float32))
               for _ in range(3))
    launches = packed_segment_attention_nt.launches
    out = packed_segment_attention_nt(q, k, v, seg)
    assert packed_segment_attention_nt.launches == launches
    assert torch.equal(out, packed_segment_attention_nt_reference(q, k, v, seg))
    with pytest.raises(ValueError, match="CUDA"):
        packed_segment_attention_nt(q.to("meta"), k.to("meta"), v.to("meta"),
                                    seg.to("meta"))


def test_encode_text_packed_pairwise_mask_matches_jax():
    """The [R, P, P] bool mask form (dense attention) against the JAX
    method with bridged weights, at a tiny text config; the segment form
    gives the same states on the segments' rows."""
    jcfg = tiny_config()
    rng = np.random.default_rng(5)
    batch = jax.tree.map(jnp.asarray, random_code_batch(
        rng, batch=2, text_len=16, max_nodes=8, max_edges_per_graph=12,
        text_vocab=1000, num_kg_nodes=500))
    jmodel = JaxTokenizer(jcfg)
    params = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False))(batch)["params"]

    R, P = 2, 24
    ids = rng.integers(1, 1000, (R, P)).astype(np.int32)
    seg = np.zeros((R, P), np.int32)
    seg[0, :6], seg[0, 6:15], seg[1, :10] = 1, 2, 1
    pos = np.tile(np.arange(P) % 6, (R, 1)).astype(np.int32)
    pm = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(pm), jnp.asarray(pos),
                                   method=JaxTokenizer.encode_text_packed))

    cfg = MedTokConfig.from_dict({"model": dataclasses.asdict(jcfg)}).model
    model = MultimodalTokenizer(cfg)
    model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                          strict=True)
    ti, tp = torch.from_numpy(ids), torch.from_numpy(pos)
    with torch.no_grad():
        dense = model.encode_text_packed(ti, torch.from_numpy(pm), tp)
        flash = model.encode_text_packed(ti, torch.from_numpy(seg), tp)
    assert dense.shape == want.shape == (R * P, jcfg.text.hidden_size)
    np.testing.assert_allclose(dense.numpy(), want, atol=1e-4, rtol=0)
    valid = seg.reshape(-1) > 0
    np.testing.assert_allclose(flash.numpy()[valid], dense.numpy()[valid],
                               atol=2e-5, rtol=0)


def test_profile_bert_runs_every_leg_on_cpu(capsys):
    out = profile_bert.main(["--rows", "2", "--len", "16", "--reps", "1",
                             "--trials", "2", "--device", "cpu"])
    legs = ("full", "full_flash", "embed_ln", "qkvo_ffn", "attn_core_fp32",
            "attn_core_bf16", "ln_gelu", "kernel_only", "kernel_nt_only",
            "dense_core_only")
    assert all(np.isfinite(out[f"{leg}_ms"]) and out[f"{leg}_ms"] > 0 for leg in legs)
    assert set(out["launches_per_call"]) == set(legs)
    # on the CPU every wrapper takes its plain version: no kernel launches
    assert all(n == 0 for leg in out["launches_per_call"].values() for n in leg.values())
    assert out["device"] == "cpu" and out["gemm_peak_flops"] == 989e12
    assert out["shape"] == "R=2 P=16 bf16"
    assert capsys.readouterr().out.strip().endswith("}")
    with pytest.raises(ValueError, match="multiple of 8"):
        profile_bert.main(["--len", "12", "--device", "cpu"])
