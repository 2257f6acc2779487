"""Port vs JAX: packed segment attention (plain version of kernel K2)
against the Pallas kernel in interpret mode at precision 'highest'."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medtok_tpu.ops.flash_attention import packed_segment_attention as jax_psa
from medtok_tpu_torch.data.packing import pack_store_meta
from medtok_tpu_torch.ops.flash_attention import (
    packed_segment_attention,
    packed_segment_attention_reference,
)


def _packed_segments(rng, rows: int, row_len: int) -> np.ndarray:
    """Segment ids of a real greedy packing, with empty tail slots and the
    last row left entirely as padding."""
    lens = rng.integers(3, 40, size=4 * rows).astype(np.int32)
    n = int(np.searchsorted(np.cumsum(lens), (rows - 1) * row_len * 0.8))
    arena = np.ones(int(lens.sum()), np.int32)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    _, flat_base, tl = pack_store_meta(arena, start, lens, np.arange(n),
                                       row_len=row_len, num_rows=rows)
    seg = np.zeros(rows * row_len, np.int32)
    for c, (b, ln) in enumerate(zip(flat_base, tl)):
        seg[b:b + ln] = c + 1
    seg = seg.reshape(rows, row_len)
    assert (seg[-1] == 0).all() and (seg[:-1] == 0).any()
    return seg


@pytest.mark.parametrize("row_len,block", [(128, 128), (256, 128)])
def test_reference_matches_pallas_kernel(row_len, block):
    # (256, 128): two key blocks, so the kernel's online softmax carries over
    rng = np.random.default_rng(0)
    B, H, Dh = 3, 2, 16
    seg = _packed_segments(rng, B, row_len)
    q, k, v = (rng.normal(size=(B, H, row_len, Dh)).astype(np.float32)
               for _ in range(3))
    want = jax_psa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(seg), block_q=block, block_k=block,
                   interpret=True, precision="highest")
    got = packed_segment_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # all-padding query rows are exactly zero, on both sides
    pad = seg == 0
    assert (got.numpy().transpose(0, 2, 1, 3)[pad] == 0).all()
    assert (np.asarray(want).transpose(0, 2, 1, 3)[pad] == 0).all()


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(_packed_segments(rng, 2, 128))
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 128, 8)).astype(np.float32))
               for _ in range(3))
    launches = packed_segment_attention.launches
    out = packed_segment_attention(q, k, v, seg, sm_scale=0.3)
    assert packed_segment_attention.launches == launches
    assert torch.equal(out, packed_segment_attention_reference(q, k, v, seg,
                                                               sm_scale=0.3))
    with pytest.raises(ValueError, match="CUDA"):
        packed_segment_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                 seg.to("meta"))
