"""Builds the CUDA kernels under ``medtok_tpu_torch/csrc/`` at first use.

Each ``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``medtok_tpu_torch/_build/`` under a name keyed by a hash of the sources,
the headers they include (``*.cuh``) and the flags, so an unchanged tree
reuses it and a changed one rebuilds. Processes that start at once (the
ranks of a ``torchrun``) take a file lock beside the library, so one of
them builds and the others load what it built.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.

Every kernel with a head or embedding width is built at the widths in
``KERNEL_WIDTHS``; a wrapper zero-pads a narrower input up to the next one
(``kernel_width``, ``pad_width``) and cuts the output back (``cut_width``).
Zero columns add exact zeros to every dot product and squared norm, so the
padded launch computes the same scores; the output columns that come from
the zero columns are cut off. A width above the widest built one takes the
kernel's wide route (``route_width`` returns None for it): kernels that
read the width at run time, so no width is too wide for them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# K3's trailing arguments: B, H, Lq, Lk, Dh, sm_scale, rate, threshold,
# seed (pointer to one int64 on the device), is_bf16, stream
_K3_TAIL = [_I, _I, _I, _I, _I, _F, _F, _U, _P, _I, _P]
# C signatures of the entry points: name -> (argtypes, restype)
_SIGNATURES = {
    # z, e, n_rows_z, n_codes, dim, k, n_splits, tiles_per_split,
    # scratch, part_vals, part_idx, vals, idx, stream
    "medtok_topk_l2": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
                       ctypes.c_int),
    # z rows a block, codebook rows a tile, at a built width
    "medtok_topk_tile_b": ([_I], ctypes.c_int),
    "medtok_topk_tile_n": ([_I], ctypes.c_int),
    # the wide route: z, e, B, N, dim, then the plan's dim in whole chunks,
    # k, splits, tiles a split, z rows a distance chunk, the sweep's
    # shared-memory bytes, the selection's row_shared, sort_shared and
    # shared-memory bytes, then scratch, part_vals, part_idx, vals, idx,
    # stream
    "medtok_topk_l2_wide": ([_P, _P] + [_I] * 12 + [_P] * 6, ctypes.c_int),
    # the wide route's selection alone: dist, B, N, k, row_shared,
    # sort_shared, shared-memory bytes, sort scratch, vals, idx, stream
    "medtok_topk_select": ([_P] + [_I] * 6 + [_P] * 4, ctypes.c_int),
    # q, k, v, seg, out, B, H, L, Dh, sm_scale, is_bf16, stream
    "medtok_segment_attention": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], ctypes.c_int),
    # as medtok_segment_attention, q/k/v/out in [B, L, H, Dh]
    "medtok_segment_attention_nt": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], ctypes.c_int),
    # the fp32 wide route of either: q, k, v, seg, out, scratch, B, H, L,
    # Dh, sm_scale, nt (1: the [B, L, H, Dh] layout), stream
    "medtok_segment_attention_wide": (
        [_P] * 6 + [_I, _I, _I, _I, _F, _I, _P], ctypes.c_int),
    # the bf16 wide route: q, k, v, seg, out, B, H, L, Dh, sm_scale, nt,
    # then the plan's slices and shared-memory bytes, stream
    "medtok_segment_attention_wide_mma": (
        [_P] * 5 + [_I, _I, _I, _I, _F, _I, _I, _I, _P], ctypes.c_int),
    # src, dst, w, out, lists, offsets (scratch), B, Ln, Epg, stream
    "medtok_adj_count": ([_P] * 6 + [_I, _I, _I, _P], ctypes.c_int),
    "medtok_adj_count_onehot": ([_P] * 6 + [_I, _I, _I, _P], ctypes.c_int),
    # Count tiles per graph at Ln nodes (K5 and K5-lane)
    "medtok_adj_lane_tiles": ([_I], ctypes.c_int),
    # q, k, v, mask, out, lse, *K3_TAIL
    "medtok_flash_fwd": ([_P] * 6 + _K3_TAIL, ctypes.c_int),
    # q, k, v, mask, lse, delta, dO, dq, *K3_TAIL
    "medtok_flash_dq": ([_P] * 8 + _K3_TAIL, ctypes.c_int),
    # q, k, v, mask, lse, delta, dO, dk, dv, *K3_TAIL
    "medtok_flash_dkv": ([_P] * 9 + _K3_TAIL, ctypes.c_int),
    # the wide routes: the same pointers, then the fp32 scratch of the sums
    "medtok_flash_fwd_wide": ([_P] * 7 + _K3_TAIL, ctypes.c_int),
    # the bf16 forward's: q, k, v, mask, out, lse, then the plan's slices,
    # chunks a slice (3 or 4), Q resident (0 / 1) and shared-memory bytes
    "medtok_flash_fwd_wide_mma": ([_P] * 6 + [_I] * 4 + _K3_TAIL, ctypes.c_int),
    "medtok_flash_dq_wide": ([_P] * 9 + _K3_TAIL, ctypes.c_int),
    # the bf16 dq's: q, k, v, mask, lse, delta, dO, dq, then the plan's
    # slices, Q / dO resident (0 / 1) and shared-memory bytes
    "medtok_flash_dq_wide_mma": ([_P] * 8 + [_I] * 3 + _K3_TAIL, ctypes.c_int),
    # ... dk, dv, scratch, query groups of 32 a split, *K3_TAIL (fp32)
    "medtok_flash_dkv_wide": ([_P] * 10 + [_I] + _K3_TAIL, ctypes.c_int),
    # the bf16 dk / dv's: q, k, v, mask, lse, delta, dO, dk, dv, then the
    # plan's slices, K / V resident (0 / 1) and shared-memory bytes
    "medtok_flash_dkv_wide_mma": ([_P] * 9 + [_I] * 3 + _K3_TAIL, ctypes.c_int),
    # x, y, numel, the fit's 12 fp32 coefficients (host memory, lowest
    # first), x_hi, x_lo, stream
    "medtok_gelu_fit": ([_P, _P, ctypes.c_int64, _P, _F, _F, _P], ctypes.c_int),
    "medtok_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build printed (ptxas register / shared-memory report)
build_log = ""
build_seconds = 0.0


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(str(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels of medtok_tpu_torch "
        "need the CUDA toolkit to build"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmedtok_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(lib_tmp), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if nvcc is missing or
    a source does not compile."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                find_nvcc()             # raises before anything is written
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(path.with_suffix(".lock"), "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not path.exists():
                        t0 = time.perf_counter()
                        build_log = _build(path)
                        build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


#: the widths the kernels are built at, narrowest first
KERNEL_WIDTHS = (16, 32, 64, 128, 256)


def kernel_width(width: int, what: str) -> int:
    """The narrowest width in KERNEL_WIDTHS that holds ``width``; raises,
    naming the limit, for a width outside 1..256."""
    for w in KERNEL_WIDTHS:
        if 1 <= width <= w:
            return w
    raise ValueError(f"the kernels take {what} 1 to {KERNEL_WIDTHS[-1]}, got {width}")


def route_width(width: int, what: str) -> int | None:
    """The built width that runs ``width`` (``kernel_width``), or None for
    a width above the widest built one, which takes the wide route; raises,
    naming the limit, for a width below 1."""
    if width > KERNEL_WIDTHS[-1]:
        return None
    return kernel_width(width, what)


def pad_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its last dimension zero-padded to ``width`` (x itself, no
    copy, when it is that wide already)."""
    if x.shape[-1] == width:
        return x
    return F.pad(x, (0, width - x.shape[-1]))


def cut_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """The first ``width`` columns of x's last dimension, contiguous (x
    itself when it is that wide)."""
    return x if x.shape[-1] == width else x[..., :width].contiguous()


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        msg = load_library().medtok_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch ({msg})")
