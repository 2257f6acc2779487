"""K3-dq's plain version (``flash_attention_dq_reference``, the oracle the
card holds the bf16 wide dq kernel to) against the Pallas dq kernel
(``_flash_bwd_dq_kernel``, run in interpret mode through the JAX function's
custom VJP) at the EHR encoder's wide head width: Dh 320 (cli.ehr
--input-dim 640 --num-heads 2), Lq 130 queries against Lk 600 keys (two of
the Pallas kernel's 512-key blocks, the second partial), dropout 0.5, a
batch row whose keys are all masked (dq = 0). The wrapper on CPU tensors
returns the plain version's result. fp32 within 1e-5 of the largest
element; bf16 at precision 'default' within one bf16 ulp of each term of
the sum (sm_scale |ds| |k|) with under 1% of the elements differing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu_torch.ops import flash_attention as fa

ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
SEED = 321


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_plain_version_matches_pallas_dq_at_the_wide_width(dtype):
    B, H, Lq, Lk, Dh, rate = 2, 1, 130, 600, 320, 0.5
    rng = np.random.default_rng(Dh + Lq)
    q, do = (rng.normal(size=(B, H, Lq, Dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, H, Lk, Dh)).astype(np.float32) for _ in range(2))
    mask = np.stack([np.arange(Lk) % 3 != 1, np.zeros(Lk, bool)])  # row 1: no valid key
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(td) for x in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
                       for t in (tq, tk, tv, tdo))
    precision = "highest" if dtype == "float32" else "default"

    def forward(q_):
        return jfa.flash_attention(q_, jk, jv, jnp.asarray(mask), dropout_rate=rate,
                                   dropout_seed=SEED, interpret=True, precision=precision)

    _, vjp = jax.vjp(forward, jq)
    want = np.asarray(vjp(jdo)[0].astype(jnp.float32))

    tmask = torch.from_numpy(mask)
    kw = dict(sm_scale=1.0 / Dh ** 0.5, dropout_rate=rate, dropout_seed=SEED)
    out, lse = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    delta = (tdo.float() * out.float()).sum(-1)
    bwd = (tq, tk, tv, tmask, lse, delta, tdo)
    got = fa.flash_attention_dq(*bwd, **kw)                  # the wrapper, on the CPU
    assert got.dtype == td and got.shape == tq.shape
    assert torch.equal(got, fa.flash_attention_dq_reference(*bwd, **kw))
    assert not got[1].float().abs().sum() and not np.abs(want[1]).sum()
    got = got.float().numpy()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(float(np.abs(want).max()), 1.0), diff.max()
        return
    terms, _, _ = fa.flash_attention_grad_terms(*bwd, **kw)
    tol = ULP * terms.numpy() + 1e-6
    assert (diff <= tol).all(), f"{int((diff > tol).sum())} beyond one ulp of the terms"
    assert float((diff > 0).mean()) < 0.01, f"{100 * (diff > 0).mean():.3f}% differ"
