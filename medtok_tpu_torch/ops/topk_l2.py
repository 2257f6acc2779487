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
sweep writes the distances of z rows in chunks whose scratch stays under
``WIDE_SCRATCH_FLOATS`` and a radix select takes the k smallest of each row
by (value, index), reading the row a fixed number of times whatever k is:
order-preserving keys of the distances (in shared memory where the row
fits), the k-th smallest key by at most four 8-bit digit passes, the keys
below it and the first equal ones compacted in index order (ties to the
lowest index), the k survivors sorted bitonically in shared memory (k up
to ``SELECT_SORT_MAX``) or by a stable radix sort through global scratch;
``wide_plan`` (``select_plan``) picks those routes; ``select_smallest``
runs the selection alone on any [B, N] fp32 matrix. It takes any D and any
k up to N, and counts its launches apart (``fused_topk_l2.wide_launches``;
the selection's in ``fused_topk_l2.select_launches``).

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
# The selection above WIDE_CAP, as csrc/topk_l2.cu lays it out: threads a
# block (one block a row), histogram bins, the most survivors (k rounded up
# to a power of 2) sorted in shared memory, bytes of its reductions; the
# shared memory a block may take
SELECT_THREADS, SELECT_BINS, SELECT_SORT_MAX, SELECT_MISC = 512, 256, 4096, 2048
SMEM_MAX = 232_448


@dataclasses.dataclass(frozen=True)
class WideSweepPlan:
    """The launch of the wide sweep: z and the codebook at width ``dim``
    (the true width rounded up to whole chunks); ``splits`` runs of
    ``tiles_per_split`` codebook tiles of WIDE_TILE rows, a grid of
    (ceil(rows / WIDE_ROWS), splits) blocks; ``cap``: the length of the
    register lists that select k (8 or 16), or 0 for k above WIDE_CAP, when
    the sweep writes the distances of ``rows`` z rows at a time for the
    radix select; ``smem`` bytes of dynamic shared memory of the sweep.
    The selection's route (k above WIDE_CAP): ``row_shared``, the row's
    keys in shared memory (else each pass reads the distances again);
    ``sort_shared``, the k survivors sorted there (else through global
    scratch); ``select_smem`` bytes (0 for k up to WIDE_CAP)."""

    dim: int
    splits: int
    tiles_per_split: int
    cap: int
    rows: int
    smem: int
    row_shared: bool = False
    sort_shared: bool = False
    select_smem: int = 0

    @property
    def grid(self) -> tuple[int, int]:
        return (-(-self.rows // WIDE_ROWS), self.splits)

    def scratch_floats(self, B: int, N: int, k: int) -> int:
        """Floats of the route's scratch: hi and lo of z and the codebook,
        |e|^2 with one +inf after it, |z|^2; above WIDE_CAP one chunk's
        [rows, N] distances and, for the global sort, 8-byte alignment and
        its [rows, 2, k] 8-byte survivors."""
        n = 2 * (B + N) * self.dim + B + N + 1
        if self.cap:
            return n
        return n + self.rows * N + (0 if self.sort_shared else 2 + 4 * self.rows * k)


def select_smem(N: int, k: int, row_shared: bool, sort_shared: bool) -> int:
    """Dynamic shared memory of the selection (the kernel's select_smem):
    the survivors to sort, one histogram of SELECT_BINS a warp (two tables
    for the global sort), SELECT_MISC bytes, the row's keys with 3 words of
    slack."""
    warps = SELECT_THREADS // 32
    return ((8 * _pow2_at_least(k) if sort_shared else 0)
            + 4 * warps * SELECT_BINS * (1 if sort_shared else 2) + SELECT_MISC
            + (4 * (N + 3) if row_shared else 0))


def _pow2_at_least(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def select_plan(N: int, k: int) -> tuple[bool, bool, int]:
    """(row_shared, sort_shared, shared-memory bytes) of the radix select
    over rows of N: the survivors sorted in shared memory when k rounds up
    to at most SELECT_SORT_MAX, the row's keys kept there when they fit
    beside them within SMEM_MAX."""
    sort_shared = _pow2_at_least(k) <= SELECT_SORT_MAX
    row_shared = select_smem(N, k, True, sort_shared) <= SMEM_MAX
    return row_shared, sort_shared, select_smem(N, k, row_shared, sort_shared)


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
    chunks whose [rows, N] distances (and the global sort's survivors, 4
    floats each) stay within WIDE_SCRATCH_FLOATS; the codebook's tiles
    split so that one chunk's row blocks x splits fill one wave of one
    block an SM (split_plan). Above WIDE_CAP the selection's route is
    select_plan's."""
    cap = next((c for c in _WIDE_LISTS if k <= c), 0)
    row_shared, sort_shared, sel = False, False, 0
    rows = B
    if not cap:
        row_shared, sort_shared, sel = select_plan(N, k)
        rows = max(1, min(B, WIDE_SCRATCH_FLOATS // (N + (0 if sort_shared else 4 * k))))
    splits, per = split_plan(-(-rows // WIDE_ROWS), -(-N // WIDE_TILE), sms)
    stage = 2 * (WIDE_ROWS + WIDE_TILE) * WIDE_CHUNK * 4 + WIDE_TILE * 4
    return WideSweepPlan(WIDE_CHUNK * -(-D // WIDE_CHUNK), splits, per, cap, rows,
                         WIDE_STAGES * stage + 16 * WIDE_STAGES, row_shared, sort_shared, sel)


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
    scratch = torch.empty(plan.scratch_floats(B, N, k), dtype=torch.float32, device=dev)
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
            plan.tiles_per_split, plan.rows, plan.smem, int(plan.row_shared),
            int(plan.sort_shared), plan.select_smem, scratch.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "topk_l2_wide")
    fused_topk_l2.wide_launches += 1
    if not plan.cap:
        fused_topk_l2.select_launches += 1
    return vals, idx


def select_smallest(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] f32, indices [B, k] i32) of the k smallest entries of
    each row of dist [B, N] f32 by (value, index): -0 equals +0 (ties to
    the lowest index), NaN last. The wide route's selection on its own: on
    a CUDA tensor the radix select (one launch, ``select_smallest.launches``),
    on a CPU tensor the plain stable sort (``topk_smallest``)."""
    if dist.dtype != torch.float32 or dist.dim() != 2 or not dist.is_contiguous():
        raise ValueError(f"dist must be a contiguous 2-D float32 tensor, got {dist.dtype} "
                         f"{tuple(dist.shape)}")
    B, N = dist.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must be in [1, N={N}]")
    if dist.device.type == "cpu":
        vals, idx = topk_smallest(dist, k)
        return vals, idx.to(torch.int32)
    if dist.device.type != "cuda":
        raise ValueError(f"dist on {dist.device}: it must be on a CUDA device or the CPU")
    if max(B, N) >= 2**31 or dist.data_ptr() % 4:
        raise ValueError("the selection takes fewer than 2**31 rows and columns, 4-byte aligned")
    dev = dist.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    row_shared, sort_shared, sel = select_plan(N, k)
    sort_scratch = torch.empty(0 if sort_shared else B * 2 * k, dtype=torch.int64, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.medtok_topk_select(
            dist.data_ptr(), B, N, k, int(row_shared), int(sort_shared), sel,
            sort_scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "topk_select")
    select_smallest.launches += 1
    return vals, idx


select_smallest.launches = 0

#: launches of the CUDA kernels, the 3xTF32 sweep, the wide route, and of
#: those the ones above WIDE_CAP that ran the radix select (CPU calls of the
#: plain version do not count)
fused_topk_l2.launches = 0
fused_topk_l2.wide_launches = 0
fused_topk_l2.select_launches = 0
