"""Kernel K1: the codebook top-k sweep (replaces the Pallas kernel
``medtok_tpu/ops/vq_pallas.py::fused_topk_l2``).

``fused_topk_l2(z, codebook, k)`` returns (values [B, k] f32, indices [B, k]
i32) of the k smallest squared-L2 distances of each z row to the codebook
rows, ties to the lowest index. On CUDA tensors it launches
``csrc/topk_l2.cu``; on CPU tensors it runs the plain version
``fused_topk_l2_reference``. A region of the codebook is a row slice, which
reaches the kernel as a pointer offset plus a row count (no copy).

Widths and k: the kernel is built at 16, 32, 64, 128 and 256 (the
export's codebook: 64); any other width from 1 to 256 is zero-padded up to
the next of those (z and the codebook are copied then; zero columns add
exact zeros to every distance), and it keeps k = 1 to 8 in registers. A
wider D or a larger k (``QuantizerConfig.top_k``, set through
``args.json``) takes the wide route, a second kernel in the same source: the
same 3xTF32 distances on the tensor cores (``wgmma``) for any D, the
codebook's tiles split over one wave of blocks by ``wide_plan``, selected
from the registers for k up to 16 (no [B, N] matrix); for a larger k the
sweep writes the distances of z rows in chunks whose [rows, N] scratch stays
under ``WIDE_SCRATCH_FLOATS`` and a second kernel takes the k smallest of
each row by (value, index). It takes any D and any k up to N, and counts
its launches apart (``fused_topk_l2.wide_launches``).

Precision and bound: the kernel runs on the tensor cores in 3xTF32 (each
fp32 value split into a TF32 hi and lo, z.e summed as hi.hi + hi.lo +
lo.hi in fp32). One TF32 product keeps 10 mantissa bits and would change
which codewords are nearest; 3xTF32 keeps about 22, so a distance between
unit rows is off by at most about 1.5e-6, under the 1e-5 gap within which
two distances count as tied. The sweep is bound by its 2*B*N*D operations:
at the export's shape (z [4096, 64], e [21000, 64]) three TF32 products
take at least 0.0667 ms on an H100's tensor cores, fp32 FMAs on its CUDA
cores 0.1643 ms. The kernel's source note gives its design.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from medtok_tpu_torch.ops import _build
from medtok_tpu_torch.ops.vq import squared_distance, topk_smallest

_MAX_K = 8          # the 3xTF32 kernel's top-k in registers
#: floats of the wide route's distance scratch for one chunk of z rows
WIDE_SCRATCH_FLOATS = 1 << 26
# The wide sweep's blocks, as csrc/topk_l2.cu lays them out: z rows a block,
# codebook rows a tile, columns a staged chunk, stages, the largest k its
# register lists hold, the list lengths it is built with
WIDE_ROWS, WIDE_TILE, WIDE_CHUNK, WIDE_STAGES, WIDE_CAP = 128, 128, 32, 3, 16
_WIDE_LISTS = (8, WIDE_CAP)


@dataclasses.dataclass(frozen=True)
class WideSweepPlan:
    """The launch of the wide sweep: z and the codebook at width ``dim``
    (the true width rounded up to whole chunks); ``splits`` runs of
    ``tiles_per_split`` codebook tiles of WIDE_TILE rows, a grid of
    (ceil(rows / WIDE_ROWS), splits) blocks; ``cap``: the length of the
    register lists that select k (8 or 16), or 0 for k above WIDE_CAP, when
    the sweep writes the distances of ``rows`` z rows at a time for a
    second kernel to select from; ``smem`` bytes of dynamic shared
    memory."""

    dim: int
    splits: int
    tiles_per_split: int
    cap: int
    rows: int
    smem: int

    @property
    def grid(self) -> tuple[int, int]:
        return (-(-self.rows // WIDE_ROWS), self.splits)


def fused_topk_l2_reference(
    z: torch.Tensor, codebook: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the fp32 distance matrix, then the k smallest
    by a stable (value, index) sort."""
    vals, idx = topk_smallest(squared_distance(z, codebook), k)
    return vals, idx.to(torch.int32)


def _check(z: torch.Tensor, codebook: torch.Tensor, k: int) -> int | None:
    """Raise on anything K1 does not take; returns the width the 3xTF32
    kernel runs at (the embedding width padded up to one it is built at),
    or None for the wide route (k above 8 or a width above 256)."""
    for name, t in (("z", z), ("codebook", codebook)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    D, N = z.shape[1], codebook.shape[0]
    if codebook.shape[1] != D:
        raise ValueError(f"z {tuple(z.shape)} and codebook {tuple(codebook.shape)} "
                         "differ in width")
    width = _build.route_width(D, "embedding width")
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must be in [1, N={N}]: the sweep takes the k "
                         "nearest of the codebook's N rows")
    if max(z.shape[0], N) >= 2**31:
        raise ValueError("K1 takes fewer than 2**31 rows of z and of the codebook")
    return width if k <= _MAX_K else None


def split_plan(row_blocks: int, tiles: int, sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of the codebook's ``tiles``: as many splits
    as fill one wave of ``row_blocks`` x splits blocks, one block an SM (a
    block's shared memory takes the SM), at least one tile each."""
    splits = max(1, min(tiles, sms // row_blocks))
    per = math.ceil(tiles / splits)
    return math.ceil(tiles / per), per


def wide_plan(B: int, N: int, D: int, k: int, sms: int) -> WideSweepPlan:
    """The wide sweep's plan for z [B, D] against N codebook rows: width D
    in whole chunks; the smallest list that holds k, else 0 and z rows in
    chunks whose [rows, N] distances stay within WIDE_SCRATCH_FLOATS; the
    codebook's tiles split so that one chunk's row blocks x splits fill one
    wave of one block an SM (split_plan)."""
    cap = next((c for c in _WIDE_LISTS if k <= c), 0)
    rows = B if cap else max(1, min(B, WIDE_SCRATCH_FLOATS // N))
    splits, per = split_plan(-(-rows // WIDE_ROWS), -(-N // WIDE_TILE), sms)
    stage = 2 * (WIDE_ROWS + WIDE_TILE) * WIDE_CHUNK * 4 + WIDE_TILE * 4
    return WideSweepPlan(WIDE_CHUNK * -(-D // WIDE_CHUNK), splits, per, cap, rows,
                         WIDE_STAGES * stage + 16 * WIDE_STAGES)


def fused_topk_l2(
    z: torch.Tensor, codebook: torch.Tensor, *, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] f32, indices [B, k] i32) of the k nearest codebook rows.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return fused_topk_l2_reference(z, codebook, k)
    if z.device != codebook.device or z.device.type != "cuda":
        raise ValueError(
            f"z on {z.device} and codebook on {codebook.device}: both must "
            "be on one CUDA device (or both on the CPU)")
    width = _check(z, codebook, k)
    B, N = z.shape[0], codebook.shape[0]
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=z.device),
                torch.empty((0, k), dtype=torch.int32, device=z.device))

    if width is None:
        return _wide(z, codebook, k)

    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    splits, per_split = split_plan(math.ceil(B / lib.medtok_topk_tile_b(width)),
                                   math.ceil(N / lib.medtok_topk_tile_n(width)), sms)

    dev = z.device
    # the split kernel's hi and lo of z and the codebook, |e|^2 with one +inf
    # after it, |z|^2
    scratch = torch.empty(2 * (B + N) * width + B + N + 1, dtype=torch.float32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    part_v, part_i = vals, idx  # one split: the sweep writes vals / idx itself
    if splits > 1:
        part_v = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    zp, ep = _build.pad_width(z, width), _build.pad_width(codebook, width)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.medtok_topk_l2(
            zp.data_ptr(), ep.data_ptr(), B, N, width, k, splits, per_split,
            scratch.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(code, "topk_l2")
    fused_topk_l2.launches += 1
    return vals, idx


def _wide(z: torch.Tensor, codebook: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide route (k above 8 or D above 256) at the true width, by
    ``wide_plan``."""
    B, N, D = z.shape[0], codebook.shape[0], z.shape[1]
    dev = z.device
    plan = wide_plan(B, N, D, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    # hi and lo of z and the codebook, |e|^2 with one +inf after it, |z|^2,
    # then (k above the lists) one chunk's [rows, N] distances
    scratch = torch.empty(2 * (B + N) * plan.dim + B + N + 1 + (0 if plan.cap else
                                                                plan.rows * N),
                          dtype=torch.float32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    part_v, part_i = vals, idx  # one split, or k above the lists: unused
    if plan.cap and plan.splits > 1:
        part_v = torch.empty((plan.splits, B, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((plan.splits, B, k), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.medtok_topk_l2_wide(
            z.data_ptr(), codebook.data_ptr(), B, N, D, plan.dim, k, plan.splits,
            plan.tiles_per_split, plan.rows, plan.smem, scratch.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "topk_l2_wide")
    fused_topk_l2.wide_launches += 1
    return vals, idx


#: launches of the CUDA kernels, the 3xTF32 sweep and the wide route (CPU
#: calls of the plain version do not count)
fused_topk_l2.launches = 0
fused_topk_l2.wide_launches = 0
