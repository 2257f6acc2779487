"""ctypes bindings of the native graph runtime (``csrc/host/medtok_graph.cpp``,
the port's copy of the JAX package's ``data/native.py`` over its own build).

``NativeGraph``: CSR build, induced subgraphs and one-call batch packing into
the CodeBatch graph layout, and the compact packers that write into pooled
buffers: edges as one int32 ``(src << 16) | dst``, one uint16
``(src << 8) | dst`` when Ln <= 256, or the uint16 dst STREAM plus per-node
out-degrees (``pack_batch_stream_idx``), with per-graph edge counts.

The pool entries of a compact pack are allocated once per shape and reused
round-robin. For a batch bound for CUDA (``pinned=True``) each entry's
buffers are pinned host tensors that the C++ writes through their numpy
views, so the copies to the card run asynchronously; the entry's fence is a
``torch.cuda.Event`` recorded after those copies (``set_fence``), and the
entry waits on it before it is overwritten. For the CPU the buffers are
pageable and the fence holds nothing. ``MEDTOK_PACK_THREADS`` (read by the
C++ at each call) caps the packer's threads; ``MEDTOK_POOL_DEPTH_CAP`` caps
a pool's depth.
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np
import torch

from medtok_tpu_torch.data import host_build
from medtok_tpu_torch.utils.profiling import count

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = host_build.load("medtok_graph")
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64, f64, u64, vp = ctypes.c_int64, ctypes.c_double, ctypes.c_uint64, ctypes.c_void_p
    lib.medtok_graph_build.restype = vp
    lib.medtok_graph_build.argtypes = [i64p, i64p, i32p, i64, i64]
    lib.medtok_graph_free.argtypes = [vp]
    lib.medtok_graph_subgraph.restype = i64
    lib.medtok_graph_subgraph.argtypes = [vp, i64p, i64, i32p, i32p, i32p, i64]
    lib.medtok_graph_pack_batch.restype = i64
    lib.medtok_graph_pack_batch.argtypes = [
        vp, i64p, i64p, i64, i64, i64, f64, u64,
        i32p, u8p, i32p, i32p, f32p, i32p, i32p, f32p, i32p, i32p]
    # compact packers: (handle, node lists, shape, dropout, seed, outputs);
    # the *_idx ones read node lists from an int32 arena by row index
    lists, arena = [vp, i64p, i64p], [vp, i32p, i64p, i64p]
    shape = [i64, i64, i64, f64, u64]
    for name, head, ep in (("medtok_graph_pack_compact", lists, i32p),
                           ("medtok_graph_pack_compact16", lists, u16p),
                           ("medtok_graph_pack_compact_idx", arena, i32p),
                           ("medtok_graph_pack_compact_idx16", arena, u16p)):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = head + shape + [i32p, u8p, ep, i32p, ep, i32p]
    lib.medtok_graph_pack_stream_idx.restype = i64
    lib.medtok_graph_pack_stream_idx.argtypes = arena + shape + [
        i32p, u8p, u16p, u16p, i32p, u16p, u16p, i32p]
    lib.medtok_graph_count_edges.restype = None
    lib.medtok_graph_count_edges.argtypes = [vp, i32p, i64p, i64, i64, i64, i32p]
    _lib = lib
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _seed(seed: int) -> int:
    return int(seed) & (2**64 - 1)


def _arena_rows(arena_data: np.ndarray, arena_off: np.ndarray, indices) -> np.ndarray:
    """The rows to pack as contiguous int64, checked against the arena: the
    C++ reads arena_off[row] and arena_off[row + 1] unchecked."""
    if arena_data.dtype != np.int32:
        raise TypeError("arena_data must be int32 (warm_cache builds it)")
    if arena_off.dtype != np.int64 or not arena_off.flags.c_contiguous:
        raise TypeError("arena_off must be contiguous int64 (warm_cache builds it)")
    rows = np.ascontiguousarray(indices, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= len(arena_off) - 1):
        raise IndexError(f"rows outside the arena's {len(arena_off) - 1}")
    return rows


# the pool buffers' element types; uint16 payloads live in int16 tensors
# (the same bytes; the card widens them with & 0xFFFF) seen as uint16 by numpy
_TORCH = {np.int32: torch.int32, np.uint8: torch.uint8, np.uint16: torch.int16}


class _PoolEntry:
    """One reusable compact-batch buffer set: ``tensors`` (torch, pinned for
    a CUDA batch) and ``bufs``, their numpy views that the C++ writes.
    Buffers of one name may alias (the eval batch's aug fields)."""

    __slots__ = ("bufs", "tensors", "fence")

    def __init__(self, tensors: dict[str, torch.Tensor]):
        self.tensors = tensors
        views: dict[int, np.ndarray] = {}
        for t in tensors.values():
            if id(t) not in views:
                a = t.numpy()
                views[id(t)] = a.view(np.uint16) if t.dtype == torch.int16 else a
        self.bufs = {k: views[id(t)] for k, t in tensors.items()}
        self.fence = None

    @property
    def nbytes(self) -> int:
        """Bytes of the entry's buffers, each aliased one counted once."""
        return sum(t.nbytes for t in {id(t): t for t in self.tensors.values()}.values())

    def set_fence(self, device: torch.device | str | None = None) -> None:
        """Call after launching the copies of this entry's tensors to
        ``device``: on CUDA, records an event on the current stream, which
        the entry waits on before it is overwritten; otherwise nothing."""
        device = torch.device(device) if device is not None else None
        if device is not None and device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self.fence = ev
        else:
            self.fence = None

    def wait(self) -> None:
        if self.fence is not None:
            t0 = time.perf_counter()
            self.fence.synchronize()
            count("native.fence_wait_s", time.perf_counter() - t0)
            self.fence = None


class NativeGraph:
    """CSR graph with native induced-subgraph extraction + batch packing."""

    POOL_DEPTH = 4

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 rel: np.ndarray, num_nodes: int):
        lib = _load()
        src = np.ascontiguousarray(edge_src, np.int64)
        dst = np.ascontiguousarray(edge_dst, np.int64)
        rel = np.ascontiguousarray(rel, np.int32)
        self._lib = lib
        self._handle = lib.medtok_graph_build(
            _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
            _ptr(rel, ctypes.c_int32), len(src), num_nodes,
        )
        self.num_nodes = num_nodes
        self._pools: dict[tuple, list[_PoolEntry]] = {}
        self._pool_next: dict[tuple, int] = {}

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.medtok_graph_free(self._handle)
            self._handle = None

    def pool_bytes(self, pinned: bool | None = None) -> int:
        """Bytes held by the pools (only the pinned or pageable ones when
        ``pinned`` is given)."""
        return sum(e.nbytes for key, pool in self._pools.items()
                   if pinned is None or key[-1] == pinned for e in pool)

    def induced_subgraph(self, nodes: np.ndarray, max_edges: int = 1 << 20):
        nodes = np.ascontiguousarray(np.sort(np.asarray(nodes, np.int64)))
        src = np.empty(max_edges, np.int32)
        dst = np.empty(max_edges, np.int32)
        rel = np.empty(max_edges, np.int32)
        total = self._lib.medtok_graph_subgraph(
            self._handle, _ptr(nodes, ctypes.c_int64), len(nodes),
            _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
            _ptr(rel, ctypes.c_int32), max_edges,
        )
        n = min(total, max_edges)
        return src[:n].copy(), dst[:n].copy(), rel[:n].copy()

    @staticmethod
    def _node_data(node_lists) -> tuple[np.ndarray, np.ndarray]:
        node_off = np.zeros(len(node_lists) + 1, np.int64)
        np.cumsum([len(nl) for nl in node_lists], out=node_off[1:])
        node_data = (
            np.concatenate([np.asarray(n, np.int64) for n in node_lists])
            if node_off[-1] > 0 else np.zeros(0, np.int64)
        )
        return np.ascontiguousarray(node_data, np.int64), node_off

    def pack_batch(self, node_lists: list[np.ndarray], *, ln: int, epg: int,
                   dropout_p: float = 0.0, seed: int = 0) -> dict[str, np.ndarray]:
        """Pack B sorted node lists into the CodeBatch graph arrays (fresh
        numpy arrays; the aug fields alias the clean ones at dropout 0),
        with ``ne`` / ``ne_aug``, each graph's real edges."""
        B = len(node_lists)
        node_data, node_off = self._node_data(node_lists)
        node_ids = np.empty(B * ln, np.int32)
        node_mask = np.empty(B * ln, np.uint8)
        e = B * epg
        edge_src = np.empty(e, np.int32)
        edge_dst = np.empty(e, np.int32)
        edge_weight = np.empty(e, np.float32)
        ne = np.empty(B, np.int32)
        # the C side skips the aug pass when the aug pointers alias the clean
        if dropout_p > 0.0:
            edge_src_aug = np.empty(e, np.int32)
            edge_dst_aug = np.empty(e, np.int32)
            edge_weight_aug = np.empty(e, np.float32)
            ne_aug = np.empty(B, np.int32)
        else:
            edge_src_aug, edge_dst_aug, edge_weight_aug = edge_src, edge_dst, edge_weight
            ne_aug = ne
        truncated = self._lib.medtok_graph_pack_batch(
            self._handle, _ptr(node_data, ctypes.c_int64),
            _ptr(node_off, ctypes.c_int64), B, ln, epg,
            float(dropout_p), _seed(seed),
            _ptr(node_ids, ctypes.c_int32), _ptr(node_mask, ctypes.c_uint8),
            _ptr(edge_src, ctypes.c_int32), _ptr(edge_dst, ctypes.c_int32),
            _ptr(edge_weight, ctypes.c_float),
            _ptr(edge_src_aug, ctypes.c_int32), _ptr(edge_dst_aug, ctypes.c_int32),
            _ptr(edge_weight_aug, ctypes.c_float),
            _ptr(ne, ctypes.c_int32), _ptr(ne_aug, ctypes.c_int32),
        )
        return {
            "node_ids": node_ids.reshape(B, ln),
            "node_mask": node_mask.reshape(B, ln).astype(bool),
            "edge_src": edge_src, "edge_dst": edge_dst, "edge_weight": edge_weight,
            "edge_src_aug": edge_src_aug, "edge_dst_aug": edge_dst_aug,
            "edge_weight_aug": edge_weight_aug,
            "ne": ne, "ne_aug": ne_aug,
            "truncated": int(truncated),
        }

    def _acquire(self, key: tuple, make) -> _PoolEntry:
        """The next entry of ``key``'s pool (made on first use), after its
        fence. A pool is allocated and zero-filled whole on first use; its
        depth is POOL_DEPTH, deeper for small entries (up to 32 MB a pool,
        at most ``MEDTOK_POOL_DEPTH_CAP`` entries, default 32)."""
        pool = self._pools.get(key)
        if pool is None:
            probe = _PoolEntry(make())
            cap = int(os.environ.get("MEDTOK_POOL_DEPTH_CAP", 32))
            depth = int(min(max(self.POOL_DEPTH, (32 << 20) // max(probe.nbytes, 1)), cap))
            pool = [probe] + [_PoolEntry(make()) for _ in range(depth - 1)]
            for e in pool:
                for arr in e.bufs.values():
                    arr.fill(0)
            self._pools[key] = pool
        i = self._pool_next.get(key, 0)
        self._pool_next[key] = (i + 1) % len(pool)
        entry = pool[i]
        entry.wait()
        return entry

    @staticmethod
    def _maker(spec: dict, aug_names: dict, want_aug: bool, pinned: bool):
        """A pool entry's tensors: ``spec`` name -> (numel, numpy dtype);
        ``aug_names`` aug name -> its clean twin, aliased without aug."""
        def make():
            def alloc(n, dt):
                return torch.empty(n, dtype=_TORCH[dt], pin_memory=pinned)

            out = {name: alloc(n, dt) for name, (n, dt) in spec.items()}
            for aug, clean in aug_names.items():
                out[aug] = alloc(*spec[clean]) if want_aug else out[clean]
            return out

        return make

    def _compact_entry(self, B, ln, epg, want_aug, u16, pinned) -> _PoolEntry:
        edge_dtype = np.uint16 if u16 else np.int32
        spec = {"node_ids": (B * ln, np.int32), "node_mask": (B * ln, np.uint8),
                "edge_packed": (B * epg, edge_dtype), "ne": (B, np.int32)}
        aug = {"edge_packed_aug": "edge_packed", "ne_aug": "ne"}
        key = (B, ln, epg, bool(want_aug), u16, bool(pinned))
        return self._acquire(key, self._maker(spec, aug, want_aug, pinned))

    def _stream_entry(self, B, ln, epg, want_aug, pinned) -> _PoolEntry:
        spec = {"node_ids": (B * ln, np.int32), "node_mask": (B * ln, np.uint8),
                "outdeg": (B * ln, np.uint16), "edge_packed": (B * epg, np.uint16),
                "ne": (B, np.int32)}
        aug = {"outdeg_aug": "outdeg", "edge_packed_aug": "edge_packed", "ne_aug": "ne"}
        key = (B, ln, epg, bool(want_aug), "stream", bool(pinned))
        return self._acquire(key, self._maker(spec, aug, want_aug, pinned))

    @staticmethod
    def _compact_out(b: dict, truncated: int, B: int, ln: int, want_aug: bool) -> dict:
        if truncated < 0:
            raise ValueError(f"ln={ln} rejected by native compact pack")
        return {
            "node_ids": b["node_ids"].reshape(B, ln),
            "node_mask": b["node_mask"].reshape(B, ln),
            "edge_packed": b["edge_packed"],
            "ne": b["ne"],
            "edge_packed_aug": b["edge_packed_aug"] if want_aug else None,
            "ne_aug": b["ne_aug"] if want_aug else None,
            "truncated": int(truncated),
        }

    def pack_batch_compact(self, node_lists: list[np.ndarray], *, ln: int, epg: int,
                           dropout_p: float = 0.0, seed: int = 0, want_aug: bool = False,
                           pinned: bool = False) -> tuple[dict, _PoolEntry]:
        """Compact pack of node lists into pooled buffers. Returns (arrays,
        pool entry); call ``entry.set_fence(device)`` after launching the
        copies of ``entry.tensors``."""
        if ln > 32768:
            raise ValueError(f"ln={ln} exceeds the 15-bit compact src limit")
        t0 = time.perf_counter()
        B = len(node_lists)
        node_data, node_off = self._node_data(node_lists)
        u16 = ln <= 256
        entry = self._compact_entry(B, ln, epg, want_aug, u16, pinned)
        b = entry.bufs
        fn = (self._lib.medtok_graph_pack_compact16 if u16
              else self._lib.medtok_graph_pack_compact)
        ect = ctypes.c_uint16 if u16 else ctypes.c_int32
        truncated = fn(
            self._handle, _ptr(node_data, ctypes.c_int64),
            _ptr(node_off, ctypes.c_int64), B, ln, epg, float(dropout_p), _seed(seed),
            _ptr(b["node_ids"], ctypes.c_int32), _ptr(b["node_mask"], ctypes.c_uint8),
            _ptr(b["edge_packed"], ect), _ptr(b["ne"], ctypes.c_int32),
            _ptr(b["edge_packed_aug"], ect), _ptr(b["ne_aug"], ctypes.c_int32),
        )
        count("native.pack_s", time.perf_counter() - t0)
        return self._compact_out(b, truncated, B, ln, want_aug), entry

    def pack_batch_compact_idx(self, arena_data: np.ndarray, arena_off: np.ndarray,
                               indices: np.ndarray, *, ln: int, epg: int,
                               dropout_p: float = 0.0, seed: int = 0,
                               want_aug: bool = False,
                               pinned: bool = False) -> tuple[dict, _PoolEntry]:
        """Compact pack of the warm-cache arena's rows ``indices`` (int32
        arena, int64 offsets): no per-code Python in the path."""
        if ln > 32768:
            raise ValueError(f"ln={ln} exceeds the 15-bit compact src limit")
        idxs = _arena_rows(arena_data, arena_off, indices)
        B = len(idxs)
        u16 = ln <= 256
        entry = self._compact_entry(B, ln, epg, want_aug, u16, pinned)
        b = entry.bufs
        t0 = time.perf_counter()
        fn = (self._lib.medtok_graph_pack_compact_idx16 if u16
              else self._lib.medtok_graph_pack_compact_idx)
        ect = ctypes.c_uint16 if u16 else ctypes.c_int32
        truncated = fn(
            self._handle, _ptr(arena_data, ctypes.c_int32),
            _ptr(arena_off, ctypes.c_int64), _ptr(idxs, ctypes.c_int64),
            B, ln, epg, float(dropout_p), _seed(seed),
            _ptr(b["node_ids"], ctypes.c_int32), _ptr(b["node_mask"], ctypes.c_uint8),
            _ptr(b["edge_packed"], ect), _ptr(b["ne"], ctypes.c_int32),
            _ptr(b["edge_packed_aug"], ect), _ptr(b["ne_aug"], ctypes.c_int32),
        )
        count("native.pack_s", time.perf_counter() - t0)
        return self._compact_out(b, truncated, B, ln, want_aug), entry

    def pack_batch_stream_idx(self, arena_data: np.ndarray, arena_off: np.ndarray,
                              indices: np.ndarray, *, ln: int, epg: int,
                              dropout_p: float = 0.0, seed: int = 0,
                              want_aug: bool = False,
                              pinned: bool = False) -> tuple[dict, _PoolEntry]:
        """STREAM-encoded compact pack (big node buckets): a uint16 dst
        stream grouped by source node plus per-node uint16 out-degrees
        instead of (src, dst) pairs, 2 bytes an edge."""
        if ln > 65536 or epg > 65535:
            raise ValueError(f"stream pack rejects ln={ln}/epg={epg}")
        idxs = _arena_rows(arena_data, arena_off, indices)
        B = len(idxs)
        entry = self._stream_entry(B, ln, epg, want_aug, pinned)
        b = entry.bufs
        t0 = time.perf_counter()
        u16 = ctypes.c_uint16
        truncated = self._lib.medtok_graph_pack_stream_idx(
            self._handle, _ptr(arena_data, ctypes.c_int32),
            _ptr(arena_off, ctypes.c_int64), _ptr(idxs, ctypes.c_int64),
            B, ln, epg, float(dropout_p), _seed(seed),
            _ptr(b["node_ids"], ctypes.c_int32), _ptr(b["node_mask"], ctypes.c_uint8),
            _ptr(b["outdeg"], u16), _ptr(b["edge_packed"], u16),
            _ptr(b["ne"], ctypes.c_int32),
            _ptr(b["outdeg_aug"], u16), _ptr(b["edge_packed_aug"], u16),
            _ptr(b["ne_aug"], ctypes.c_int32),
        )
        count("native.pack_s", time.perf_counter() - t0)
        out = self._compact_out(b, truncated, B, ln, want_aug)
        out["outdeg"] = b["outdeg"].reshape(B, ln)
        out["outdeg_aug"] = b["outdeg_aug"].reshape(B, ln) if want_aug else None
        return out, entry

    def count_edges(self, arena_data: np.ndarray, arena_off: np.ndarray,
                    lo: int, hi: int, *, ln: int) -> np.ndarray:
        """Induced-edge count of each row in [lo, hi) of the warm-cache
        arena, node lists cut to ``ln`` (what a pack at that ln emits)."""
        _arena_rows(arena_data, arena_off, [lo, hi - 1] if hi > lo else [])
        out = np.empty(hi - lo, np.int32)
        self._lib.medtok_graph_count_edges(
            self._handle, _ptr(arena_data, ctypes.c_int32),
            _ptr(arena_off, ctypes.c_int64), lo, hi, ln, _ptr(out, ctypes.c_int32),
        )
        return out
