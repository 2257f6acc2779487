"""Attention kernels K2, K4 and K3 and their plain versions.

**K2**, block-diagonal packed-segment attention (replaces the Pallas kernel
``medtok_tpu/ops/flash_attention.py::packed_segment_attention``). q, k, v
are [B, H, L, Dh] and ``seg_ids`` [B, L] int32 (0 = padding). Query i
attends to key j iff seg_i == seg_j > 0; the scores q.k * sm_scale and the
softmax run in fp32 and a query row with no valid key returns 0. The
softmax walks blocks of 128 keys with a running maximum, as the TPU kernel
does (its block_k). For bf16 inputs the probabilities are rounded to bf16
before the P.V product, where the TPU kernel casts them
(``p.astype(v.dtype)``), and the row sum is taken over the unrounded ones;
fp32 inputs keep fp32 probabilities. Forward
only: the one caller is the frozen text encoder. On CUDA tensors
``packed_segment_attention`` launches ``csrc/segment_attention.cu``, whose
route follows the dtype: bf16 runs on the tensor cores (``mma.sync``,
skipping key groups whose segments cannot meet the queries'), fp32 on the
CUDA cores with exact fp32 products (the parity path). On CPU tensors it
runs the plain version. Bound: at the packed BERT shape [256, 12, 128, 64]
in bf16 the layer reads q, k and v at the positions that hold a token
(padding needs none of them) and writes all of the output, at most
4 x 50.3 MB (about 60 us at 3.35 TB/s), for at most 12.9 GFLOP, so it is
memory-bound; the kernel's source note gives its design.

**K4**, ``packed_segment_attention_nt`` (replaces the Pallas kernel
``packed_segment_attention_nt``): K2 with q, k, v and the output in the
projection layout [B, L, H, Dh], a free view of the [B, L, H*Dh] linear
output, so no head transposes are needed on either side. It is K2's CUDA
kernel in its [B, L, H, Dh] stride mode: same semantics and rounding
point, the same two routes by dtype, same bytes.

**K3**, flash attention with a key-padding mask and hashed
attention-probability dropout, forward plus the dq and dk/dv backward
(replaces ``medtok_tpu/ops/flash_attention.py::flash_attention``: the
kernels ``_flash_kernel``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``). ``flash_attention`` is a
``torch.autograd.Function`` over the three wrappers ``flash_attention_fwd``,
``flash_attention_dq`` and ``flash_attention_dkv``; each launches its kernel
in ``csrc/flash_attention.cu`` on CUDA tensors and runs its plain version
on CPU tensors. Semantics, as in the TPU kernel:

- softmax(q k^T * sm_scale) over the keys with ``key_mask`` True, in fp32;
- dropout after the softmax on the numerator only: a kept probability is
  p / (1 - rate), a dropped one 0, and the denominator stays undropped; the
  keep bit of element (b*H + h, i, j) is ``uniform_hash(...) >=
  int(rate * 2**32)``, the same bits as the TPU kernel's, whatever the
  tiling; the seed is an int or a 0-dim int64 tensor on the device (one
  drawn there reaches the kernels without a host sync);
- a query row with no valid key returns 0 and the finite lse -1e30, and
  gets zero gradients;
- bf16 inputs are multiplied exactly with fp32 sums, and the probabilities
  (forward) and ds / dropped probabilities (backward) round to bf16 before
  their products, where the TPU kernel casts them. The forward walks blocks
  of K3_BLOCK_K = 512 keys with a running maximum and rounds each block's
  probabilities against it, as the TPU kernel does at the block_k the EHR
  encoder calls it with; the backward recomputes exp(s - lse) with no
  running maximum.

Nothing quadratic is saved: the backward recomputes the probabilities from
the saved lse and the keep bits from the hash. The dtype picks the route:
in bf16 all three kernels run on the tensor cores (``mma.sync``; key tiles
with no valid key are never staged, and the forward walks each 512-key
block twice, for its maximum and then for P.V), in fp32 on the CUDA cores
with exact fp32 products (the parity path).

**Widths.** K2, K4 and K3 take head widths 1 to 256: each kernel is built
at 16, 32, 64, 128 and 256, and the wrapper zero-pads q, k, v (and dO) up
to the next of those and cuts the outputs back. Zero columns change no
score, so the results are those of the true width; ``sm_scale`` defaults
to 1/sqrt(Dh) of the true width, as the JAX functions take it. A width
above 256 raises.
"""

from __future__ import annotations

import math

import torch

from medtok_tpu_torch.ops import _build

_MASKED = -1e30  # finite stand-in for -inf, as in the TPU kernel
_M32 = 0xFFFFFFFF
K3_BLOCK_K = 512  # K3's key block: the TPU kernel's default block_k
SEG_BLOCK_K = 128  # K2 / K4's key block: the TPU kernel's block_k


def _block_softmax_pv(s, valid, v, block_k: int, keep=None):
    """The TPU kernels' online softmax and P V over blocks of block_k keys:
    (acc, l, m) from the fp32 masked scores s [.., Lq, Lk] and v
    [.., Lk, Dh]. In each block the probabilities exp(s - running max)
    (0 where ``valid`` is False) are summed into l unrounded, multiplied by
    ``keep`` (the dropout scale) when given, rounded to v's dtype and
    multiplied into v; the earlier sums are rescaled by exp(old max - new
    max). The running maximum m is a stabiliser and carries no gradient."""
    m = torch.full((*s.shape[:-1], 1), _MASKED, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    for c0 in range(0, s.shape[-1], block_k):
        block = slice(c0, c0 + block_k)
        m_next = torch.maximum(m, s[..., block].detach().amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.where(valid[..., block], torch.exp(s[..., block] - m_next), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = p * keep[..., block]
        acc = acc * alpha + torch.matmul(_as_fp32(p, v), v[..., block, :].float())
        m = m_next
    return acc, l, m


def packed_segment_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: the dense fp32 [B, H, L, L] masked scores,
    softmaxed over blocks of SEG_BLOCK_K keys with a running maximum, as
    the TPU kernel and the CUDA kernel walk them. In each block the
    probabilities exp(s - running max) are rounded to v's dtype before P V,
    the row sum is taken over the unrounded ones, and the earlier sums are
    rescaled by exp(old max - new max). Rows that are all padding return 0,
    as the kernel does (the dense BERT path would average them instead)."""
    Dh = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    seg = seg_ids.to(torch.int32)
    valid = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))[:, None]
    acc, l, _ = _block_softmax_pv(torch.where(valid, s, _MASKED), valid, v, SEG_BLOCK_K)
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def packed_segment_attention_nt_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain version of K4: K2's dense fp32 masked softmax on the
    [B, H, L, Dh] views of [B, L, H, Dh] inputs (bf16 probabilities
    rounded before P V, as there), returned contiguous in [B, L, H, Dh].
    Rows that are all padding return 0."""
    out = packed_segment_attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), seg_ids,
        sm_scale=sm_scale)
    return out.transpose(1, 2).contiguous()


def _device_of(tensors, what: str) -> str:
    """'cpu' when every tensor is on the CPU; 'cuda' when all are on one
    CUDA device; otherwise raises."""
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} must be on one CUDA device (or all on the CPU)")
    return "cuda"


def _segment_check(q, k, v, seg_ids, heads_dim: int) -> int:
    """Raise on anything K2 / K4 does not take; returns the head count,
    read from dimension ``heads_dim`` of q (1 for K2's [B, H, L, Dh], 2
    for K4's [B, L, H, Dh])."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one 4-D shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Dh = q.shape[0], q.shape[3]
    L = q.shape[3 - heads_dim]
    _build.kernel_width(Dh, "head width")
    if seg_ids.shape != (B, L) or seg_ids.dtype != torch.int32:
        raise ValueError(f"seg_ids must be [B, L] = [{B}, {L}] int32, got "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_ids", seg_ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return q.shape[heads_dim]


def _segment_launch(entry: str, q, k, v, seg_ids, out, heads: int,
                    sm_scale: float) -> None:
    """Build the library if needed and launch K2 or K4 (``entry``) on q's
    device and current stream, at q's width (one the kernels are built at);
    raises on a missing nvcc or a refused launch."""
    lib = _build.load_library()
    B, L, Dh = q.shape[0], seg_ids.shape[1], q.shape[3]
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
            out.data_ptr(), B, heads, L, Dh, float(sm_scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, entry)


def _segment_run(entry: str, q, k, v, seg_ids, heads: int,
                 sm_scale: float | None) -> torch.Tensor:
    """K2 or K4 (``entry``) on q, k, v zero-padded to the next width the
    kernel is built at, with sm_scale from the true width; returns the
    output cut back to it."""
    Dh = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    width = _build.kernel_width(Dh, "head width")
    qp, kp, vp = (_build.pad_width(t, width) for t in (q, k, v))
    out = torch.empty_like(qp)
    if out.numel():
        _segment_launch(entry, qp, kp, vp, seg_ids, out, heads, sm_scale)
    return _build.cut_width(out, Dh)


def packed_segment_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Block-diagonal attention (K2), [B, H, L, Dh] in and out.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if _device_of((q, k, v, seg_ids), "q, k, v and seg_ids") == "cpu":
        return packed_segment_attention_reference(q, k, v, seg_ids,
                                                  sm_scale=sm_scale)
    heads = _segment_check(q, k, v, seg_ids, heads_dim=1)
    out = _segment_run("medtok_segment_attention", q, k, v, seg_ids, heads, sm_scale)
    if out.numel():
        packed_segment_attention.launches += 1
    return out


def packed_segment_attention_nt(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_ids: torch.Tensor,
    *, sm_scale: float | None = None,
) -> torch.Tensor:
    """Block-diagonal attention (K4), [B, L, H, Dh] in and out.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if _device_of((q, k, v, seg_ids), "q, k, v and seg_ids") == "cpu":
        return packed_segment_attention_nt_reference(q, k, v, seg_ids,
                                                     sm_scale=sm_scale)
    heads = _segment_check(q, k, v, seg_ids, heads_dim=2)
    out = _segment_run("medtok_segment_attention_nt", q, k, v, seg_ids, heads, sm_scale)
    if out.numel():
        packed_segment_attention_nt.launches += 1
    return out


#: launches of the CUDA kernels (CPU calls of the plain versions do not count)
packed_segment_attention.launches = 0
packed_segment_attention_nt.launches = 0


# --------------------------------------------------------------------- K3 --

def uniform_hash(seed, bh, rows, cols) -> torch.Tensor:
    """The TPU kernel's counter hash (``_uniform_hash``: splitmix/xorshift
    rounds) of the global (batch*head, query, key) coordinates, broadcast
    over its arguments. Returns the uint32 values in an int64 tensor.

    torch has no full uint32 arithmetic, so this works in int64 and keeps
    the low 32 bits after every multiply and add, before every shift; an
    int64 product wraps modulo 2**64, which leaves the low 32 bits exact."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    dev = rows.device
    cols = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    bh = torch.as_tensor(bh, dtype=torch.int64, device=dev)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev)
    x = (rows * 2654435761) & _M32
    x = x ^ ((cols * 0x85EBCA6B) & _M32)
    x = x ^ (((seed & _M32) + ((bh * 0x9E3779B9) & _M32)) & _M32)
    for shift, mult in ((16, 0x7FEB352D), (15, 0x846CA68B)):
        x = x ^ (x >> shift)
        x = (x * mult) & _M32
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """A probability is kept where its hash is at least this uint32."""
    return int(rate * 4294967296.0)


def _keep_scale(shape, rate: float, seed, device, bh_offset: int = 0) -> torch.Tensor:
    """[B, H, Lq, Lk] fp32: 1 / (1 - rate) where the hash keeps, else 0.
    Row b*H + h of the batch hashes as row bh_offset + b*H + h."""
    B, H, Lq, Lk = shape
    bh = torch.arange(bh_offset, bh_offset + B * H, device=device).view(B, H, 1, 1)
    rows = torch.arange(Lq, device=device).view(1, 1, Lq, 1)
    cols = torch.arange(Lk, device=device).view(1, 1, 1, Lk)
    keep = uniform_hash(seed, bh, rows, cols) >= dropout_threshold(rate)
    return keep.float() / (1.0 - rate)


def _key_valid(key_mask, k: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, Lk] bool from a [B, Lk] key mask (None: every key)."""
    B, _, Lk, _ = k.shape
    if key_mask is None:
        return torch.ones(B, 1, 1, Lk, dtype=torch.bool, device=k.device)
    return key_mask.to(device=k.device, dtype=torch.bool).view(B, 1, 1, Lk)


def _as_fp32(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x rounded to ``like``'s dtype, back in fp32: where the TPU kernel
    casts an fp32 operand to its partner's type before a product."""
    return x.to(like.dtype).float()


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask=None, *,
    sm_scale: float | None = None, dropout_rate: float = 0.0,
    dropout_seed=0, bh_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3's forward: dense fp32 scores, the masked softmax,
    the hashed dropout on the numerator. Returns (out [B, H, Lq, Dh] in q's
    dtype, lse [B, H, Lq] fp32). Differentiable by autograd.

    The softmax walks blocks of K3_BLOCK_K keys with a running maximum, as
    the TPU kernel does at its default block_k (the EHR encoder's): in each
    block the probabilities exp(s - running max) are rounded to v's dtype
    before P V, the row sum is taken over the unrounded ones, and the
    earlier sums are rescaled by exp(old max - new max). For Lk <= 512 the
    running maximum is the row maximum.

    ``bh_offset``: the batch*head index of q's first row in the batch whose
    dropout bits it takes, so that a slice of batch rows [b0, b1) with
    bh_offset b0*H gets the bits the whole batch gets (the plain versions'
    [B, H, Lq, Lk] tensors are checked against the kernels in such
    slices)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    valid = _key_valid(key_mask, k)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = torch.where(valid, s, _MASKED)
    keep = None
    if dropout_rate > 0.0:
        keep = _keep_scale(s.shape, dropout_rate, dropout_seed, q.device, bh_offset)
    acc, l, m = _block_softmax_pv(s, valid, v, K3_BLOCK_K, keep)
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l).to(q.dtype), (m + torch.log(safe_l)).squeeze(-1)


def _bwd_terms(q, k, v, key_mask, lse, delta, do, sm_scale, dropout_rate,
               dropout_seed, bh_offset):
    """The backward's recompute: (ds, dropped probabilities), [B, H, Lq, Lk]
    fp32, from a = exp(s - lse) and t = keep * (dO . V)."""
    valid = _key_valid(key_mask, k)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    a = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    t = torch.matmul(do.float(), v.float().transpose(-1, -2))
    a_drop = a
    if dropout_rate > 0.0:
        keep = _keep_scale(s.shape, dropout_rate, dropout_seed, q.device, bh_offset)
        t, a_drop = t * keep, a * keep
    return a * (t - delta[..., None]), a_drop


def flash_attention_dq_reference(q, k, v, key_mask, lse, delta, do, *,
                                 sm_scale: float, dropout_rate: float = 0.0,
                                 dropout_seed=0, bh_offset: int = 0) -> torch.Tensor:
    """Plain version of K3-dq: dQ = sm_scale * ds K, in q's dtype."""
    ds, _ = _bwd_terms(q, k, v, key_mask, lse, delta, do, sm_scale,
                       dropout_rate, dropout_seed, bh_offset)
    return (sm_scale * torch.matmul(_as_fp32(ds, k), k.float())).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, key_mask, lse, delta, do, *,
                                  sm_scale: float, dropout_rate: float = 0.0,
                                  dropout_seed=0, bh_offset: int = 0):
    """Plain version of K3-dkv: dK = sm_scale * ds^T Q and dV = ã^T dO."""
    ds, a_drop = _bwd_terms(q, k, v, key_mask, lse, delta, do, sm_scale,
                            dropout_rate, dropout_seed, bh_offset)
    dk = sm_scale * torch.matmul(_as_fp32(ds, q).transpose(-1, -2), q.float())
    dv = torch.matmul(_as_fp32(a_drop, do).transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_grad_terms(q, k, v, key_mask, lse, delta, do, *,
                               sm_scale: float, dropout_rate: float = 0.0,
                               dropout_seed=0, bh_offset: int = 0):
    """The sums of the magnitudes of the terms of dQ, dK and dV, fp32:
    sm_scale |ds| |K|, sm_scale |ds|^T |Q| and |ã|^T |dO|. A term whose
    bf16 rounding flips moves its sum by at most one bf16 ulp of the term,
    so these scale the tolerance of a bf16 gradient."""
    ds, a_drop = _bwd_terms(q, k, v, key_mask, lse, delta, do, sm_scale,
                            dropout_rate, dropout_seed, bh_offset)
    ds, a_drop = ds.abs(), a_drop.abs()
    return (sm_scale * torch.matmul(ds, k.float().abs()),
            sm_scale * torch.matmul(ds.transpose(-1, -2), q.float().abs()),
            torch.matmul(a_drop.transpose(-1, -2), do.float().abs()))


def _k3_check(q, k, v, key_mask, extra=()) -> int:
    """Raise on anything K3's kernels do not take; returns the width the
    kernels run at (the head width padded up to one they are built at)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q [B, H, Lq, Dh] and k, v [B, H, Lk, Dh] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Lq, Dh = q.shape
    width = _build.kernel_width(Dh, "head width")
    if Lq < 1 or k.shape[2] < 1:
        raise ValueError(f"K3 takes Lq, Lk >= 1, got {Lq}, {k.shape[2]}")
    if key_mask.shape != (B, k.shape[2]) or key_mask.dtype != torch.bool:
        raise ValueError(f"key_mask must be [B, Lk] = [{B}, {k.shape[2]}] bool, "
                         f"got {key_mask.dtype} {tuple(key_mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask), *extra):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if B * H * max(Lq, k.shape[2]) >= 2**31:
        raise ValueError("K3's index arithmetic takes fewer than 2**31 rows")
    return width


def _seed_on(seed, device) -> torch.Tensor:
    """The dropout seed as one int64 on ``device``: a tensor seed as it is,
    an int by a fill on the device; neither waits for the device."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int64 or seed.device != device:
            raise ValueError(f"a tensor dropout seed must be one int64 on {device}, "
                             f"got {seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed.reshape(())
    return torch.full((), int(seed) & _M32, dtype=torch.int64, device=device)


def _k3_launch(entry: str, q, k, tensors, sm_scale: float, dropout_rate: float,
               dropout_seed) -> None:
    """Build the library if needed and launch ``entry`` on q's device and
    current stream, with the pointers of ``tensors`` and the shapes and
    scalars every K3 entry takes, at q's width (one the kernels are built
    at); raises on a missing nvcc or a refused launch."""
    lib = _build.load_library()
    B, H, Lq, Dh = q.shape
    drop = dropout_rate > 0.0
    seed = _seed_on(dropout_seed, q.device) if drop else None
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), B, H, Lq, k.shape[2], Dh,
            float(sm_scale), float(dropout_rate),
            dropout_threshold(dropout_rate) if drop else 0,
            seed.data_ptr() if drop else None, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, entry)


def flash_attention_fwd(q, k, v, key_mask, *, sm_scale: float,
                        dropout_rate: float = 0.0, dropout_seed=0):
    """K3's forward, (out, lse). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if _device_of((q, k, v, key_mask), "K3's tensors") == "cpu":
        return flash_attention_reference(q, k, v, key_mask, sm_scale=sm_scale,
                                         dropout_rate=dropout_rate,
                                         dropout_seed=dropout_seed)
    width = _k3_check(q, k, v, key_mask)
    qp, kp, vp = (_build.pad_width(t, width) for t in (q, k, v))
    out = torch.empty_like(qp)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if out.numel():
        _k3_launch("medtok_flash_fwd", qp, kp, (qp, kp, vp, key_mask, out, lse),
                   sm_scale, dropout_rate, dropout_seed)
        flash_attention_fwd.launches += 1
    return _build.cut_width(out, q.shape[3]), lse


def _bwd_extra(q, lse, delta, do):
    B, H, Lq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Lq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, H, Lq] float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q, got {do.dtype} {tuple(do.shape)}")
    return (("lse", lse), ("delta", delta), ("dO", do))


def flash_attention_dq(q, k, v, key_mask, lse, delta, do, *, sm_scale: float,
                       dropout_rate: float = 0.0, dropout_seed=0):
    """K3-dq: the gradient of q, from the saved lse and delta = sum(dO * O).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    tensors = (q, k, v, key_mask, lse, delta, do)
    if _device_of(tensors, "K3's tensors") == "cpu":
        return flash_attention_dq_reference(*tensors, sm_scale=sm_scale,
                                            dropout_rate=dropout_rate,
                                            dropout_seed=dropout_seed)
    width = _k3_check(q, k, v, key_mask, _bwd_extra(q, lse, delta, do))
    qp, kp, vp, dop = (_build.pad_width(t, width) for t in (q, k, v, do))
    dq = torch.empty_like(qp)
    if dq.numel():
        _k3_launch("medtok_flash_dq", qp, kp, (qp, kp, vp, key_mask, lse, delta, dop, dq),
                   sm_scale, dropout_rate, dropout_seed)
        flash_attention_dq.launches += 1
    return _build.cut_width(dq, q.shape[3])


def flash_attention_dkv(q, k, v, key_mask, lse, delta, do, *, sm_scale: float,
                        dropout_rate: float = 0.0, dropout_seed=0):
    """K3-dkv: the gradients of k and v. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    tensors = (q, k, v, key_mask, lse, delta, do)
    if _device_of(tensors, "K3's tensors") == "cpu":
        return flash_attention_dkv_reference(*tensors, sm_scale=sm_scale,
                                             dropout_rate=dropout_rate,
                                             dropout_seed=dropout_seed)
    width = _k3_check(q, k, v, key_mask, _bwd_extra(q, lse, delta, do))
    qp, kp, vp, dop = (_build.pad_width(t, width) for t in (q, k, v, do))
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    if dk.numel():
        _k3_launch("medtok_flash_dkv", qp, kp,
                   (qp, kp, vp, key_mask, lse, delta, dop, dk, dv), sm_scale,
                   dropout_rate, dropout_seed)
        flash_attention_dkv.launches += 1
    Dh = q.shape[3]
    return _build.cut_width(dk, Dh), _build.cut_width(dv, Dh)


#: launches of each CUDA kernel (CPU calls of the plain versions do not count)
flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K3-fwd forward; D = sum(dO * O) in fp32 by a torch op, then K3-dq and
    K3-dkv, as the TPU version's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale, dropout_rate, dropout_seed):
        out, lse = flash_attention_fwd(q, k, v, key_mask, sm_scale=sm_scale,
                                       dropout_rate=dropout_rate,
                                       dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, key_mask, lse, out)
        ctx.args = dict(sm_scale=sm_scale, dropout_rate=dropout_rate,
                        dropout_seed=dropout_seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, lse, out = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = flash_attention_dq(q, k, v, key_mask, lse, delta, g, **ctx.args)
        dk, dv = flash_attention_dkv(q, k, v, key_mask, lse, delta, g, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None, *,
                    sm_scale: float | None = None, dropout_rate: float = 0.0,
                    dropout_seed: int | torch.Tensor = 0) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v without the L^2 scores, differentiable:
    q [B, H, Lq, Dh], k, v [B, H, Lk, Dh], key_mask [B, Lk] (True = valid),
    output [B, H, Lq, Dh] in q's dtype. ``dropout_seed`` (an int or a 0-dim
    int64 tensor on q's device) picks the hashed dropout mask (see the
    module docstring)."""
    B, H, Lq, Dh = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    if key_mask is None:
        key_mask = torch.ones(B, k.shape[2], dtype=torch.bool, device=k.device)
    key_mask = key_mask.to(dtype=torch.bool).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 key_mask, float(sm_scale), float(dropout_rate),
                                 dropout_seed)

