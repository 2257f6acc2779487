"""The launch plans of the bf16 wide routes (head widths above 256) on the
tensor cores: K2 / K4 (``segment_wide_plan``), K3's forward
(``flash_fwd_wide_plan``), K3's dq (``flash_dq_wide_plan``) and K3's dk / dv
(``flash_dkv_wide_plan``). The kernels run only on the card; the plans are
plain Python, computed by the wrappers and passed to the kernels, so they
are held here:

- every output column falls in exactly one slice, as few slices as hold
  the width at 192 (K2 / K4), 256 (K3's forward), 192 (K3's dq) or 128
  (K3's dk / dv) columns each; the slice widths are the kernels' builds:
  192 for K2 / K4, 192 or 256 for K3's forward, 192 for its dq, 128 for its
  dk / dv;
- shared memory within the card's 232,448 bytes a block and at least what
  the kernel's layout takes (its stages, resident Q or K / V, the key-mask
  bits or lse / D, and the output tiles);
- grids within CUDA's limits at the shapes the card runs them at;
- the plans' constants are the kernels' (read from the CUDA sources), and
  the register split of a warp-specialized block fills one block's launch
  registers, one block an SM;
- the plain versions (the kernels' oracle on the card) against the Pallas
  kernels in interpret mode at the widths the entry points' flags give
  that the width tests do not run: K2 / K4 at Dh 384 on 128-token packed
  rows, K3's forward at Dh 320 over four 512-key blocks, the last partial.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.ops import flash_attention as jfa
from medtok_tpu_torch.ops import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
SMEM_MAX = 232_448
ROW_BYTES = 64 * 2              # a staged chunk's row in shared memory
GRID_X_MAX, GRID_YZ_MAX = 2**31 - 1, 65535
KINDS = ("K2", "K4", "K3-fwd", "K3-dkv", "K3-dq")
SLICE_MOST = {"K2": 192, "K4": 192, "K3-fwd": 256, "K3-dkv": 128, "K3-dq": 192}
# the kernels' templates
SLICE_BUILT = {"K2": (192,), "K4": (192,), "K3-fwd": (192, 256), "K3-dkv": (128,),
               "K3-dq": (192,)}
ULP = 2.0 ** -7  # bf16 keeps 8 significant bits


def _plan(kind: str, Dh: int, B: int = 3, H: int = 2, L: int = 300, Lk: int = 1100):
    """The plan the wrapper takes for q of width Dh: K2's [B, H, L, Dh]
    and K4's [B, L, H, Dh] read the same (B, H, L); K3's q is [B, H, L, Dh]
    against Lk keys."""
    if kind == "K3-fwd":
        return fa.flash_fwd_wide_plan(B * H, L, Lk, Dh)
    if kind == "K3-dkv":
        return fa.flash_dkv_wide_plan(B * H, L, Lk, Dh)
    if kind == "K3-dq":
        return fa.flash_dq_wide_plan(B * H, L, Lk, Dh)
    return fa.segment_wide_plan(B, H, L, Dh)


@pytest.mark.parametrize("kind", KINDS)
def test_wide_plan_puts_every_column_in_one_slice(kind):
    for Dh in range(257, 2049):
        plan = _plan(kind, Dh)
        w = plan.slice_width
        assert w in SLICE_BUILT[kind] and w % 8 == 0, (Dh, plan)
        assert plan.chunks == w // 64
        assert plan.slices == -(-Dh // SLICE_MOST[kind]), (Dh, plan)  # as few as hold Dh
        cols = [c for i in range(plan.slices) for c in range(i * w, min((i + 1) * w, Dh))]
        assert cols == list(range(Dh)), (Dh, plan)
        assert (plan.slices - 1) * w < Dh, (Dh, plan)  # no slice is empty


@pytest.mark.parametrize("kind", KINDS)
def test_wide_plan_shared_memory_fits_the_card_and_the_layout(kind):
    for Dh in range(257, 2049):
        plan = _plan(kind, Dh)
        out_tile = plan.block_rows * (plan.slice_width + 8) * 2
        if kind == "K3-dkv":  # dK's and dV's tiles, both staged at the end
            out_tile *= 2
        assert out_tile <= plan.smem <= SMEM_MAX, (Dh, plan)
        if kind == "K3-dq":
            # Q's and dO's 128-row chunks resident beside four stages of K's
            # and V's chunk of a 64-key tile, else all four chunks in every
            # stage; then 4 mbarriers and the key-mask bits
            chunks, tile = -(-Dh // 64), 64
            small = 16 * 4 + 4 * -(-1100 // 32)
            resident = (2 * chunks * 128 + 4 * 2 * tile) * ROW_BYTES + small
            assert plan.q_resident == (resident <= SMEM_MAX), (Dh, plan)
            need = resident if plan.q_resident else 4 * 2 * (tile + 128) * ROW_BYTES + small
            assert plan.block_rows == 128 and plan.smem >= need, (Dh, plan)
            continue
        if kind == "K3-dkv":
            # resident K and V (two 128-key chunks a 64 columns) beside four
            # stages of Q's and dO's 64-query chunk, else K's and V's chunk
            # in every stage too; then lse and D of two tiles, 4 mbarriers
            chunks, small = -(-Dh // 64), 2 * 2 * 64 * 4 + 16 * 4
            resident = (2 * chunks * 128 + 4 * 2 * 64) * ROW_BYTES + small
            assert plan.q_resident == (resident <= SMEM_MAX), (Dh, plan)
            need = resident if plan.q_resident else 4 * 2 * (64 + 128) * ROW_BYTES + small
            assert plan.block_rows == 128 and plan.smem >= need, (Dh, plan)
            continue
        if kind != "K3-fwd":
            # four stages of Q's and K's chunk, then a key block's segment ids
            assert plan.block_rows == 128 and not plan.q_resident
            assert plan.smem >= max(4 * (128 + 128) * ROW_BYTES, out_tile) + 128 * 4 + 16 + 64
            continue
        chunks, bits = -(-Dh // 64), 4 * -(-1100 // 32) + 16 * 4  # and 4 stages' mbarriers
        resident = (chunks * 128 + 4 * 64) * ROW_BYTES + bits
        # Q stays in shared memory exactly where it fits
        assert plan.q_resident == (resident <= SMEM_MAX), (Dh, plan)
        need = resident if plan.q_resident else 4 * (128 + 64) * ROW_BYTES + bits
        assert plan.block_rows == 128 and plan.smem >= need, (Dh, plan)


# the shapes the card runs the bf16 wide routes at: chip_smoke.py's
# check_wide_routes (K2 / K4 on 5 rows of edge segments, H = 2, L = 300; K3
# q [3*2, 300], k [1100]), wide_times (K2 / K4 [256, 4, 128, 320]; K3 [8*2,
# 1100, 320]) and the path witnesses (the export's text encoder at 768 / 2
# heads on [rows, 128]; EHRTrainer at 640 / 2 heads, L = 2003)
SEGMENT_SHAPES = [(5, 2, 300, Dh) for Dh in (257, 320, 512, 1000)] + [
    (256, 4, 128, 320), (16, 2, 128, 384), (256, 2, 128, 384)]
K3_SHAPES = [(6, 300, 1100, Dh) for Dh in (257, 320, 512, 1000)] + [
    (16, 1100, 1100, 320), (32, 2003, 2003, 320), (512, 2003, 2003, 320)]


@pytest.mark.parametrize("B,H,L,Dh", SEGMENT_SHAPES)
def test_segment_wide_grid_within_cuda_limits(B, H, L, Dh):
    plan = fa.segment_wide_plan(B, H, L, Dh)
    x, y, z = plan.grid
    assert (y, z) == (1, 1) and 1 <= x <= GRID_X_MAX
    assert x == B * H * -(-L // 128) * plan.slices  # one block a (b, h, 128 queries, slice)


@pytest.mark.parametrize("BH,Lq,Lk,Dh", K3_SHAPES)
def test_flash_fwd_wide_grid_within_cuda_limits(BH, Lq, Lk, Dh):
    plan = fa.flash_fwd_wide_plan(BH, Lq, Lk, Dh)
    x, y, z = plan.grid
    assert (y, z) == (1, 1) and 1 <= x <= GRID_X_MAX and max(y, z) <= GRID_YZ_MAX
    assert x == BH * -(-Lq // 128) * plan.slices  # one block a (b*h, 128 queries, slice)
    assert plan.smem <= SMEM_MAX


@pytest.mark.parametrize("BH,Lq,Lk,Dh", K3_SHAPES)
def test_flash_dkv_wide_grid_within_cuda_limits(BH, Lq, Lk, Dh):
    """One block a (b*h, 128 keys, slice): no query split, so no scratch
    and no second kernel."""
    plan = fa.flash_dkv_wide_plan(BH, Lq, Lk, Dh)
    x, y, z = plan.grid
    assert (y, z) == (1, 1) and 1 <= x <= GRID_X_MAX
    assert x == BH * -(-Lk // 128) * plan.slices
    assert plan.smem <= SMEM_MAX


@pytest.mark.parametrize("BH,Lq,Lk,Dh", K3_SHAPES)
def test_flash_dq_wide_grid_within_cuda_limits(BH, Lq, Lk, Dh):
    """One block a (b*h, 128 queries, slice): no key split, so no scratch
    and no second kernel."""
    plan = fa.flash_dq_wide_plan(BH, Lq, Lk, Dh)
    x, y, z = plan.grid
    assert (y, z) == (1, 1) and 1 <= x <= GRID_X_MAX
    assert x == BH * -(-Lq // 128) * plan.slices
    assert plan.slices == -(-Dh // 192)
    assert plan.smem <= SMEM_MAX


@pytest.mark.parametrize("Dh,resident,smem", [
    (320, True, 229_580), (512, False, 196_812), (1000, False, 196_812)])
def test_flash_dq_wide_plan_keeps_q_and_do_resident_where_they_fit(Dh, resident, smem):
    """At Dh 320 Q's and dO's 128 rows (160 KB) stay in shared memory beside
    four 16 KB stages of 64 keys; at 512 and 1000 they come with every
    score step (four stages of 48 KB)."""
    plan = fa.flash_dq_wide_plan(16, 1100, 1100, Dh)
    assert plan.q_resident == resident and plan.smem == smem
    assert plan.slices == -(-Dh // 192)


@pytest.mark.parametrize("Dh,resident", [(320, True), (512, False), (1000, False)])
def test_flash_dkv_wide_plan_keeps_k_and_v_resident_where_they_fit(Dh, resident):
    """At Dh 320 K's and V's 128 rows (160 KB) stay in shared memory beside
    four 16 KB stages; at 512 and 1000 they come with every score step."""
    plan = fa.flash_dkv_wide_plan(16, 1100, 1100, Dh)
    assert plan.q_resident == resident and plan.slices == -(-Dh // 128)
    assert plan.smem == (230_464 if resident else 197_696)


def test_wide_plans_raise_past_their_grid_and_shared_memory():
    with pytest.raises(ValueError, match="blocks"):
        fa.segment_wide_plan(2**16, 2**8, 2**14, 300)
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_fwd_wide_plan(2**20, 2**18, 10, 300)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_fwd_wide_plan(1, 10, 4_000_000, 300)
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_dkv_wide_plan(2**20, 10, 2**18, 300)
    with pytest.raises(ValueError, match="above 192"):
        fa.flash_dkv_wide_plan(1, 10, 10, 192)
    with pytest.raises(ValueError, match="blocks"):
        fa.flash_dq_wide_plan(2**20, 2**18, 10, 300)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_dq_wide_plan(1, 10, 4_000_000, 300)


def test_wide_plan_constants_are_the_kernels():
    """The plans size what the CUDA sources lay out: chunk width, padded
    row, slice limit, block rows, key tiles and stages; and setmaxnreg's
    split gives the consumers exactly the registers the producer frees from
    a launch of X_REGS_LAUNCH a thread (the count each launch checks), which
    no two blocks' launches fit in one SM's 65,536."""
    def const(path, name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / path).read_text())
        assert m, name
        return m.group(1).split("//")[0].strip()

    assert const("wide.cuh", "XC") == str(fa.WIDE_CHUNK)
    assert const("wide.cuh", "X_SMEM_MAX") == str(fa.WIDE_SMEM_MAX)
    threads, low, high = (int(const("wide.cuh", n))
                          for n in ("X_THREADS", "X_REGS_PRODUCER", "X_REGS_CONSUMER"))
    launch = (128 * low + 256 * high) // threads
    assert threads == 384 and launch * threads == 128 * low + 256 * high
    assert launch * threads <= 65536 < 2 * launch * threads
    assert launch % 8 == 0 and low % 8 == 0 and high % 8 == 0 and 24 <= low < high <= 256
    assert const("segment_attention.cu", "XST_SEG") == str(fa._SEG_WIDE_STAGES)
    assert const("segment_attention.cu", "XNV_SEG") == str(fa._SEG_WIDE_SLICE // 64)
    assert const("segment_attention.cu", "SEG_SMALL") == "KC * 4 + 16 + 16 * XST_SEG"
    assert fa._SEG_WIDE_SMALL == 128 * 4 + 16 + 16 * fa._SEG_WIDE_STAGES
    assert const("segment_attention.cu", "SWQ") == str(fa._SEG_WIDE_ROWS)
    assert const("segment_attention.cu", "KC") == str(fa.SEG_BLOCK_K)
    assert const("flash_attention.cu", "XST_FWD") == str(fa._FWD_WIDE_STAGES)
    assert const("flash_attention.cu", "XNV_FWD") == str(fa._FWD_WIDE_SLICE // 64)
    assert const("flash_attention.cu", "MW") == str(fa._FWD_WIDE_ROWS // 16)
    assert const("flash_attention.cu", "FWD_THREADS") == "X_THREADS"
    assert const("segment_attention.cu", "SW_THREADS") == "X_THREADS"
    assert const("flash_attention.cu", "MT") == str(fa._FWD_WIDE_TILE)
    assert const("flash_attention.cu", "KB") == str(fa.K3_BLOCK_K)
    assert const("flash_attention.cu", "XST_DKV") == str(fa._DKV_WIDE_STAGES)
    assert const("flash_attention.cu", "XNV_DKV") == str(fa._DKV_WIDE_SLICE // 64)
    assert const("flash_attention.cu", "DKV_KEYS") == str(fa._DKV_WIDE_ROWS)
    assert const("flash_attention.cu", "DKV_QT") == str(fa._DKV_WIDE_TILE)
    assert const("flash_attention.cu", "DKV_THREADS") == "X_THREADS"
    assert const("flash_attention.cu", "DKV_SMALL") == "2 * 2 * DKV_QT * 4 + 16 * XST_DKV"
    assert fa._DKV_WIDE_SMALL == 2 * 2 * fa._DKV_WIDE_TILE * 4 + 16 * fa._DKV_WIDE_STAGES
    assert const("flash_attention.cu", "XST_DQ") == str(fa._DQ_WIDE_STAGES)
    assert const("flash_attention.cu", "DQ_THREADS") == "X_THREADS"
    assert const("flash_attention.cu", "DQ_QCHUNK") == "MR * XC * 2"
    assert fa._DQ_WIDE_ROWS == 16 * int(const("flash_attention.cu", "MW"))
    assert const("flash_attention.cu", "XNT_DQ") == str(fa._DQ_WIDE_TILE) == "64"
    assert 64 * int(const("flash_attention.cu", "XNV_DQ")) == fa._DQ_WIDE_SLICE == 192


@pytest.mark.parametrize("heads_dim", [1, 2], ids=["K2", "K4"])
def test_segment_check_plans_the_bf16_wide_route_in_both_layouts(heads_dim):
    seg = torch.ones(2, 5, dtype=torch.int32)
    for Dh in (257, 320, 1000):
        shape = [2, 5, Dh]
        shape.insert(heads_dim, 3)
        q = torch.zeros(shape, dtype=torch.bfloat16)
        assert fa._segment_check(q, q, q, seg, heads_dim) == (3, None)


def _assert_close(dtype, name, got, want, terms):
    """fp32 within 1e-5 of want's largest element; bf16 within one ulp of
    want plus one of each term, under 1% of the elements differing."""
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(float(np.abs(want).max()), 1.0), (name, diff.max())
        return
    tol = ULP * (np.abs(want) + terms) + 1e-6
    assert (diff <= tol).all(), f"{name}: {int((diff > tol).sum())} beyond one ulp"
    assert float((diff > 0).mean()) < 0.01, f"{name}: {100 * (diff > 0).mean():.3f}% differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["K2", "K4"])
def test_segment_plain_version_matches_pallas_at_the_export_width(kind, dtype):
    """cli.train --text-hidden 768 --text-heads 2: head width 384 (two
    192-column slices on the card), 128-token rows packed with codes'
    descriptions of several lengths and a padding tail."""
    nt, (B, H, L, Dh) = kind == "K4", (2, 2, 128, 384)
    i = np.arange(L)
    seg = np.stack([np.where(i < 117, np.searchsorted([9, 40, 41, 88, 117], i, "right") + 1,
                             0), np.where(i < 64, i // 16 + 1, 0)]).astype(np.int32)
    rng = np.random.default_rng(384 + nt)
    shape = (B, L, H, Dh) if nt else (B, H, L, Dh)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(td)
                  for _ in range(3))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)) for t in (tq, tk, tv))
    jfn = jfa.packed_segment_attention_nt if nt else jfa.packed_segment_attention
    fn = fa.packed_segment_attention_nt if nt else fa.packed_segment_attention
    plain = fa.packed_segment_attention_nt_reference if nt else \
        fa.packed_segment_attention_reference
    precision = "highest" if dtype == "float32" else "default"
    want = np.asarray(jfn(jq, jk, jv, jnp.asarray(seg), interpret=True,
                          precision=precision).astype(jnp.float32))
    tseg = torch.from_numpy(seg)
    got = fn(tq, tk, tv, tseg)                         # the wrapper, on the CPU
    assert got.dtype == td and got.shape == shape
    assert torch.equal(got, plain(tq, tk, tv, tseg))
    terms = plain(tq.float(), tk.float(), tv.float().abs(), tseg)
    _assert_close(dtype, f"{kind} out", got.float().numpy(), want, terms.numpy())
    assert not got[(tseg == 0)[:, :, None].expand(B, L, H) if nt else
                   (tseg == 0)[:, None, :].expand(B, H, L)].float().abs().sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_forward_plain_version_matches_pallas_at_the_ehr_width(dtype):
    """cli.ehr --input-dim 640 --output-dim 640 --num-heads 2: head width
    320 (two 192-column slices on the card); Lk = 1600 keys are four of the
    forward's 512-key blocks, the last partial; dropout 0.5."""
    B, H, Lq, Lk, Dh = 1, 2, 48, 1600, 320
    rng = np.random.default_rng(Dh + Lk)
    q = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, Lk, Dh)).astype(np.float32) for _ in range(2))
    mask = (np.arange(Lk) < 1453)[None]
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)) for t in (tq, tk, tv))
    kw = dict(dropout_rate=0.5, dropout_seed=31)
    precision = "highest" if dtype == "float32" else "default"
    want = np.asarray(jfa.flash_attention(jq, jk, jv, jnp.asarray(mask), interpret=True,
                                          precision=precision, **kw).astype(jnp.float32))
    tmask = torch.from_numpy(mask)
    kw["sm_scale"] = 1.0 / Dh ** 0.5
    out, lse = fa.flash_attention_fwd(tq, tk, tv, tmask, **kw)   # the wrapper, on the CPU
    plain, plain_lse = fa.flash_attention_reference(tq, tk, tv, tmask, **kw)
    assert out.dtype == td and torch.equal(out, plain) and torch.equal(lse, plain_lse)
    terms, _ = fa.flash_attention_reference(tq.float(), tk.float(), tv.float().abs(), tmask,
                                            **kw)
    _assert_close(dtype, "K3 out", out.float().numpy(), want, terms.numpy())
