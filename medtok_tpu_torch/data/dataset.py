"""MedCodeDataset, the static-shape bucketing collator and the shuffled
epoch iterator (counterpart of ``medtok_tpu/data/dataset.py``).

One sample per medical code: the tokenized description plus the code's
induced KG subgraph. The dataset is built from in-memory columns
(``med_code``, ``desc``, ``pkg_index_list``); ``from_path`` reads them from
an all_codes_mappings ``.parquet`` (through pandas and pyarrow, which the
port does not require) or from a ``.jsonl`` copy of the same three columns, one JSON object
a line (the ``json`` module; ``write_jsonl`` writes one). JSON Lines is only
a container for the same columns: both give the same dataset.

Two routes build the batches. The native one (``native=True``, the default,
as the JAX package's wherever a C++ compiler is found) tokenizes with the
C++ WordPiece (``data/native_text.py``) and packs graphs with the C++
packer (``data/native.py``), which also draws the training view's edge
dropout bits: bit for bit the JAX package's default route.
``make_batch_compact`` writes a CompactCodeBatch into the packer's pooled
(for CUDA, pinned) buffers. The numpy route (``native=False``) tokenizes in
Python, extracts each subgraph in numpy and pads with ``collate``, the edge
dropout drawn from a numpy generator seeded per batch: bit for bit the JAX
package's numpy route, kept as the witness of the native one.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from medtok_tpu_torch.config import DataConfig
from medtok_tpu_torch.data.kg import KnowledgeGraph, edge_dropout
from medtok_tpu_torch.data.packing import pack_store_meta
from medtok_tpu_torch.data.text import WordPieceTokenizer
from medtok_tpu_torch.data.types import CodeBatch, CompactCodeBatch
from medtok_tpu_torch.utils.profiling import count


@dataclass
class CodeSample:
    index: int
    med_code: str
    input_ids: np.ndarray       # [L] unpadded
    nodes: np.ndarray           # sorted global KG node ids
    edge_src: np.ndarray        # local indices into nodes
    edge_dst: np.ndarray
    rel: np.ndarray


# At or above this padded node count, make_batch_compact takes the STREAM
# edge encoding (uint16 dst + per-node out-degrees, 2 bytes an edge): the big
# buckets' padded edge buffers are most of the export's copied bytes.
STREAM_MIN_NODES = 128


def _pick_bucket(buckets: Sequence[int], needed: int) -> int:
    for b in buckets:
        if needed <= b:
            return b
    return buckets[-1]


class _TextStore:
    """Tokenized descriptions: one flat growable arena (int16 when the
    vocabulary fits) + per-row (start, length) vectors; ``get`` returns
    views."""

    def __init__(self, n: int, vocab_size: int):
        self.start = np.full(n, -1, np.int64)
        self.length = np.zeros(n, np.int32)
        self.dtype = np.int16 if vocab_size < 32768 else np.int32
        self.arena = np.empty(1 << 16, self.dtype)
        self.tail = 0

    def __contains__(self, i: int) -> bool:
        return bool(self.start[i] >= 0)

    def missing(self, rows: np.ndarray) -> np.ndarray:
        return rows[self.start[rows] < 0]

    def get(self, i: int) -> np.ndarray:
        s = self.start[i]
        return self.arena[s:s + self.length[i]]

    def _reserve(self, extra: int) -> None:
        need = self.tail + extra
        if need > len(self.arena):
            arena = np.empty(max(need, 2 * len(self.arena)), self.dtype)
            arena[: self.tail] = self.arena[: self.tail]
            self.arena = arena

    def put_flat(self, rows: np.ndarray, out: np.ndarray, lens: np.ndarray) -> None:
        """Insert rows from an [n, max_len] id matrix and per-row counts
        (``encode_batch_flat``'s layout) in one boolean-mask extraction."""
        total = int(lens.sum())
        self._reserve(total)
        cols = np.arange(out.shape[1])
        # row-major boolean extraction == the rows concatenated in order
        self.arena[self.tail:self.tail + total] = out[cols[None, :] < lens[:, None]]
        starts = np.empty(len(lens), np.int64)
        starts[0] = self.tail
        np.cumsum(lens[:-1], out=starts[1:])
        starts[1:] += self.tail
        self.start[rows] = starts
        self.length[rows] = lens
        self.tail += total

    def put_one(self, i: int, ids: np.ndarray) -> None:
        self._reserve(len(ids))
        self.arena[self.tail:self.tail + len(ids)] = ids
        self.start[i] = self.tail
        self.length[i] = len(ids)
        self.tail += len(ids)


class MedCodeDataset:
    """The code vocabulary + KG, serving CodeSamples and padded batches.

    ``native`` picks the route (module docstring); a C++ build that fails
    raises. ``cache_dir`` keeps the tokenized descriptions in
    ``med_code_descriptions.npz`` there (``save_text_cache``), read back
    when its row count matches and its ids fit the store's dtype."""

    def __init__(
        self,
        kg: KnowledgeGraph,
        med_codes: Sequence[str],
        descs: Sequence[str],
        pkg_index_lists: Sequence,
        tokenizer: WordPieceTokenizer,
        *,
        cfg: DataConfig = DataConfig(),
        cache_dir: str | Path | None = None,
        native: bool = True,
    ):
        if not (len(med_codes) == len(descs) == len(pkg_index_lists)):
            raise ValueError("med_code, desc and pkg_index_list differ in length")
        self.cfg = cfg
        self.kg = kg
        self.med_codes = [str(c) for c in med_codes]
        self.descs = list(descs)
        self.pkg_index_lists = list(pkg_index_lists)
        self.tokenizer = tokenizer
        self._text = _TextStore(len(self.med_codes), len(tokenizer.vocab))
        self._graph_cache: dict[int, tuple] = {}
        self._node_arena: np.ndarray | None = None        # warm_cache()
        self._node_arena_off: np.ndarray | None = None
        self._code_index: dict[str, int] | None = None
        self._cache_file = (Path(cache_dir) / "med_code_descriptions.npz"
                            if cache_dir is not None else None)
        if self._cache_file is not None and self._cache_file.exists():
            with np.load(self._cache_file) as z:
                start, length, arena = z["start"], z["length"], z["arena"]
            # the astype below must not narrow: a cache written under a
            # larger vocabulary (int32 arena) would wrap ids above 32767
            # negative in an int16 store, so such a cache is re-tokenized
            fits = arena.size == 0 or int(arena.max()) <= np.iinfo(self._text.dtype).max
            if len(start) == len(self.med_codes) and fits:
                self._text.start, self._text.length = start, length
                self._text.arena = arena.astype(self._text.dtype)
                self._text.tail = len(arena)
        self.native = None
        self._encoder = tokenizer
        if native:
            from medtok_tpu_torch.data.native import NativeGraph
            from medtok_tpu_torch.data.native_text import NativeWordPiece

            self.native = NativeGraph(kg.edge_src, kg.edge_dst, kg.rel_index, kg.num_nodes)
            self._encoder = NativeWordPiece(tokenizer)

    @classmethod
    def from_columns(cls, kg: KnowledgeGraph, columns: dict, tokenizer, *,
                     cfg: DataConfig = DataConfig(), **kw) -> "MedCodeDataset":
        return cls(kg, columns["med_code"], columns["desc"],
                   columns["pkg_index_list"], tokenizer, cfg=cfg, **kw)

    @classmethod
    def from_path(cls, kg: KnowledgeGraph, path: str | Path, tokenizer, *,
                  cfg: DataConfig = DataConfig(), **kw) -> "MedCodeDataset":
        """Read the vocabulary columns from a ``.parquet`` (needs pandas and
        pyarrow) or a ``.jsonl`` file, by its suffix."""
        return cls.from_columns(kg, read_vocab_columns(path, VOCAB_COLUMNS), tokenizer,
                                cfg=cfg, **kw)

    def __len__(self) -> int:
        return len(self.med_codes)

    def code_at(self, idx: int) -> str:
        return self.med_codes[idx]

    def lookup(self, med_code: str) -> int:
        """Row index of a code string (built into a dict on first use)."""
        if self._code_index is None:
            self._code_index = {c: i for i, c in enumerate(self.med_codes)}
        try:
            return self._code_index[med_code]
        except KeyError:
            raise KeyError(f"unknown medical code {med_code!r}") from None

    def warm_cache(self, *, tokenize: bool = True) -> None:
        """Build the per-code node-list arena (one int32 array, each row
        sorted) and optionally tokenize every description: the host half of
        the export sweep. Rows are sorted only where a vectorized check
        finds them out of order."""
        values = self.pkg_index_lists
        n = len(values)
        lens = np.fromiter((len(v) for v in values), np.int64, n)
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        total = int(off[-1])
        arena = (np.concatenate(values, dtype=np.int32, casting="unsafe")
                 if total else np.zeros(0, np.int32))
        if total > 1:
            bad = arena[1:] < arena[:-1]
            bidx = off[1:-1] - 1        # pairs across a row boundary don't count
            # a boundary at total - 1 (empty trailing rows) has no pair
            bad[bidx[(bidx >= 0) & (bidx < total - 1)]] = False
            if bad.any():
                rows = np.unique(np.searchsorted(off, np.where(bad)[0] + 1, "right") - 1)
                for i in rows:
                    arena[off[i]:off[i + 1]].sort()
        self._node_arena_off = off
        self._node_arena = arena
        if tokenize:
            self.tokenize_rows(range(n))

    def tokenize_rows(self, rows) -> None:
        """Tokenize (and keep) the descriptions of ``rows`` not yet
        tokenized: one bulk C++ call on the native route."""
        enc = self._encoder
        max_len = self.cfg.max_text_length
        missing = self._text.missing(np.asarray(rows, np.int64))
        if missing.size == 0:
            return
        texts = [str(self.descs[i]) for i in missing]
        if hasattr(enc, "encode_batch_flat"):
            t0 = time.perf_counter()
            out, lens = enc.encode_batch_flat(texts, max_length=max_len)
            t1 = time.perf_counter()
            self._text.put_flat(missing, out, lens)
            count("text.encode_s", t1 - t0)
            count("text.store_s", time.perf_counter() - t1)
        else:
            for i, text in zip(missing, texts):
                self._text.put_one(int(i), enc.encode(text, max_length=max_len)[0])

    def save_text_cache(self) -> None:
        """Write the tokenized descriptions to ``cache_dir`` (call after a
        full pass); nothing without a ``cache_dir``."""
        if self._cache_file is None:
            return
        self._cache_file.parent.mkdir(parents=True, exist_ok=True)
        t = self._text
        np.savez(self._cache_file, start=t.start, length=t.length, arena=t.arena[: t.tail])

    def text_lengths(self, lo: int, hi: int) -> np.ndarray:
        """Token counts of rows [lo, hi) (rows must be tokenized already)."""
        return self._text.length[lo:hi].astype(np.int64)

    def node_counts(self, lo: int, hi: int) -> np.ndarray:
        """Subgraph node counts of rows [lo, hi) (after ``warm_cache``)."""
        o = self._node_arena_off
        return o[lo + 1:hi + 1] - o[lo:hi]

    def edge_counts(self, lo: int, hi: int, *, ln: int) -> np.ndarray | None:
        """Induced-edge counts of rows [lo, hi) with node lists cut to
        ``ln`` (native route after ``warm_cache``; else None)."""
        if self.native is None or self._node_arena is None:
            return None
        return self.native.count_edges(self._node_arena, self._node_arena_off, lo, hi, ln=ln)

    def node_list(self, idx: int) -> np.ndarray:
        """The sorted KG node ids of code ``idx``."""
        if self._node_arena_off is not None:
            o = self._node_arena_off
            return self._node_arena[o[idx]:o[idx + 1]]
        return np.sort(np.asarray(self.pkg_index_lists[idx], np.int64))

    def pack_text_rows(self, indices, *, row_len: int, num_rows: int):
        """Pack the tokenized descriptions of ``indices`` into fixed
        [num_rows, row_len] rows. Returns (input_ids, flat_base, lens)."""
        t = self._text
        ids, base, lens = pack_store_meta(
            t.arena, t.start, t.length, np.asarray(indices, np.int64),
            row_len=row_len, num_rows=num_rows,
        )
        count("text.tokens", int(lens.sum()))
        count("text.slots", ids.size)
        return ids, base, lens

    def text_ids(self, idx: int) -> np.ndarray:
        if idx not in self._text:
            ids, _ = self._encoder.encode(str(self.descs[idx]),
                                          max_length=self.cfg.max_text_length)
            self._text.put_one(idx, ids)
        return self._text.get(idx)

    def _node_bucket(self, indices: Sequence[int]) -> int:
        max_n = max(len(self.node_list(int(i))) for i in indices)
        return next((bi for bi, b in enumerate(self.cfg.node_buckets) if max_n <= b),
                    len(self.cfg.node_buckets) - 1)

    def batch_shapes(self, indices: Sequence[int]) -> tuple[int, int, int]:
        """(Lt, Ln, Epg) a batch of these codes starts at on the native
        route: the text bucket of the longest text, the node bucket of the
        largest graph and the edge bucket paired with it."""
        Lt = _pick_bucket(self.cfg.text_buckets,
                          max(len(self.text_ids(int(i))) for i in indices))
        bucket_i = self._node_bucket(indices)
        Ln = self.cfg.node_buckets[bucket_i]
        Epg = self.cfg.edge_buckets[min(bucket_i, len(self.cfg.edge_buckets) - 1)]
        return Lt, Ln, Epg

    def make_batch(self, indices: Sequence[int], *, aug_seed: int | None = None,
                   force_shapes: tuple[int, int, int] | None = None,
                   real: int | None = None) -> CodeBatch:
        """CodeBatch of these codes (numpy arrays). ``aug_seed`` (training)
        seeds the edge dropout of the augmented edges; without it they are
        the clean ones. On the native route the C++ packer extracts, pads
        and drops edges, starting at ``batch_shapes`` and growing the edge
        bucket while a graph's edges were cut; on the numpy route
        ``collate`` buckets by the largest counts. ``force_shapes=(Lt, Ln,
        Epg)`` pins the shapes (edges beyond Epg are cut). ``real``: the
        codes after the first ``real`` repeat-pad the batch, and count in
        the graph fill counters as slots only."""
        batch, nn, ne, ne_aug = self._build_batch(indices, aug_seed=aug_seed,
                                                  force_shapes=force_shapes)
        B, Ln = batch.node_mask.shape
        _count_graph_fill(nn, [ne] + ([ne_aug] if aug_seed is not None else []),
                          Ln, batch.edge_weight.size // B, real)
        return batch

    def _build_batch(self, indices: Sequence[int], *, aug_seed: int | None,
                     force_shapes: tuple[int, int, int] | None) -> tuple:
        """(CodeBatch, each graph's real nodes, real edges, real edges
        after the dropout): the native packer's counts; the numpy route
        (the witness) counts its arrays."""
        if self.native is None:
            rng = np.random.default_rng(aug_seed) if aug_seed is not None else None
            batch = collate([self[int(i)] for i in indices], self.cfg, rng=rng,
                            pad_id=self.tokenizer.pad_id, shapes=force_shapes)
            B = len(indices)
            ne, ne_aug = ((w.reshape(B, -1) > 0).sum(axis=1)
                          for w in (batch.edge_weight, batch.edge_weight_aug))
            return batch, batch.node_mask.sum(axis=1), ne, ne_aug

        texts = [self.text_ids(int(i)) for i in indices]
        nodes = [self.node_list(int(i)) for i in indices]
        p = self.cfg.edge_dropout_p if aug_seed is not None else 0.0

        def pack(ln, epg):
            return self.native.pack_batch(nodes, ln=ln, epg=epg, dropout_p=p,
                                          seed=aug_seed or 0)

        if force_shapes is not None:
            Lt, Ln, Epg = force_shapes
            packed = pack(Ln, Epg)
        else:
            Lt = _pick_bucket(self.cfg.text_buckets, max(len(t) for t in texts))
            bucket_i = self._node_bucket(indices)
            Ln = self.cfg.node_buckets[bucket_i]
            bucket_i = min(bucket_i, len(self.cfg.edge_buckets) - 1)
            packed = pack(Ln, self.cfg.edge_buckets[bucket_i])
            while packed["truncated"] and bucket_i < len(self.cfg.edge_buckets) - 1:
                bucket_i += 1
                packed = pack(Ln, self.cfg.edge_buckets[bucket_i])

        B = len(indices)
        input_ids = np.full((B, Lt), self.tokenizer.pad_id, np.int32)
        attention_mask = np.zeros((B, Lt), np.int32)
        for i, t in enumerate(texts):
            L = min(len(t), Lt)
            input_ids[i, :L] = t[:L]
            attention_mask[i, :L] = 1
        nn = np.minimum(np.fromiter(map(len, nodes), np.int64, B), Ln)
        return CodeBatch(
            input_ids=input_ids, attention_mask=attention_mask,
            node_ids=packed["node_ids"], node_mask=packed["node_mask"],
            edge_src=packed["edge_src"], edge_dst=packed["edge_dst"],
            edge_weight=packed["edge_weight"], edge_src_aug=packed["edge_src_aug"],
            edge_dst_aug=packed["edge_dst_aug"], edge_weight_aug=packed["edge_weight_aug"],
            code_indices=np.asarray(indices, np.int32),
        ), nn, packed["ne"], packed["ne_aug"]

    def make_batch_compact(self, indices: Sequence[int], *, aug_seed: int | None = None,
                           force_shapes: tuple[int, int, int] | None = None,
                           want_text: bool = True, pinned: bool = False,
                           real: int | None = None):
        """The batch as a CompactCodeBatch of CPU tensors. Returns
        ``(batch, fence)``: on the native route the graph fields are views
        of a pooled buffer set (pinned memory with ``pinned=True``, for a
        copy to CUDA), and ``fence.set_fence(device)`` must follow the
        launch of their copies; the set is reused a pool's depth of calls
        later, after that fence. Node buckets of ``STREAM_MIN_NODES`` and
        more take the stream encoding, Ln <= 256 the uint16 pairs, the rest
        int32 pairs. The numpy route compresses ``make_batch``'s batch
        (int32 pairs, no pool). ``want_text=False`` leaves the text fields
        [B, 0]. ``real`` as ``make_batch``'s."""
        compact, fence = self._build_compact(indices, aug_seed=aug_seed,
                                             force_shapes=force_shapes,
                                             want_text=want_text, pinned=pinned)
        B, Ln = compact.node_ids.shape
        epg = compact.edge_packed.numel() // B
        views = [compact.ne] + ([compact.ne_aug] if aug_seed is not None else [])
        _count_graph_fill(compact.nn.numpy(), [v.numpy() for v in views], Ln, epg, real)
        return compact, fence

    def _build_compact(self, indices: Sequence[int], *, aug_seed: int | None,
                       force_shapes: tuple[int, int, int] | None, want_text: bool,
                       pinned: bool):
        if force_shapes is not None:
            Lt, Ln, Epg = force_shapes
        else:
            Lt, Ln, Epg = self.batch_shapes(indices)
        want_aug = aug_seed is not None
        if self.native is None:
            # force_shapes passes through unchanged: pinning the computed
            # shapes would cut graphs where make_batch grows the edge bucket
            classic = self._build_batch(indices, aug_seed=aug_seed,
                                        force_shapes=force_shapes)[0]
            return _compress_classic(classic, classic.edge_weight.size // max(len(indices), 1),
                                     want_aug=want_aug, want_text=want_text)

        p = self.cfg.edge_dropout_p if want_aug else 0.0
        stream = Ln >= STREAM_MIN_NODES
        kw = dict(ln=Ln, dropout_p=p, seed=aug_seed or 0, want_aug=want_aug, pinned=pinned)

        def arena():
            if self._node_arena is None:
                # a mini-arena of these rows, so the idx packers serve a
                # dataset without warm_cache too (same output)
                nodes = [np.asarray(self.node_list(int(i)), np.int32) for i in indices]
                off = np.zeros(len(nodes) + 1, np.int64)
                np.cumsum([len(x) for x in nodes], out=off[1:])
                data = np.concatenate(nodes) if off[-1] else np.zeros(0, np.int32)
                return data, off, np.arange(len(nodes), dtype=np.int64)
            return self._node_arena, self._node_arena_off, np.asarray(indices, np.int64)

        def pack(epg):
            if stream:
                return self.native.pack_batch_stream_idx(*arena(), epg=epg, **kw)
            if self._node_arena is not None:
                return self.native.pack_batch_compact_idx(*arena(), epg=epg, **kw)
            return self.native.pack_batch_compact(
                [self.node_list(int(i)) for i in indices], epg=epg, **kw)

        packed, entry = pack(Epg)
        if force_shapes is None:
            # grow the edge bucket while a graph's edges were cut
            buckets = self.cfg.edge_buckets
            bucket_i = buckets.index(Epg) if Epg in buckets else len(buckets)
            while packed["truncated"] and bucket_i < len(buckets) - 1:
                bucket_i += 1
                Epg = buckets[bucket_i]
                packed, entry = pack(Epg)
        B = len(indices)
        if want_text:
            input_ids, attention_mask = self._text_block(indices, Lt)
        else:
            input_ids = attention_mask = np.zeros((B, 0), np.int32)
        if self._node_arena_off is not None:
            o = self._node_arena_off
            idx_a = np.asarray(indices, np.int64)
            nn = np.minimum(o[idx_a + 1] - o[idx_a], Ln).astype(np.int32)
        else:
            nn = np.minimum(np.fromiter((len(self.node_list(int(i))) for i in indices),
                                        np.int64, B), Ln).astype(np.int32)
        t = entry.tensors
        return CompactCodeBatch(
            input_ids=torch.from_numpy(input_ids),
            attention_mask=torch.from_numpy(attention_mask),
            node_ids=t["node_ids"].view(B, Ln), nn=torch.from_numpy(nn),
            edge_packed=t["edge_packed"], ne=t["ne"],
            edge_packed_aug=t["edge_packed_aug"] if want_aug else None,
            ne_aug=t["ne_aug"] if want_aug else None,
            code_indices=torch.from_numpy(np.asarray(indices, np.int32)),
            outdeg=t["outdeg"].view(B, Ln) if stream else None,
            outdeg_aug=t["outdeg_aug"].view(B, Ln) if stream and want_aug else None,
        ), entry

    def _text_block(self, indices: Sequence[int], Lt: int) -> tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask) [B, Lt] of these codes, filled by one
        flat scatter."""
        texts = [self.text_ids(int(i)) for i in indices]
        B = len(texts)
        input_ids = np.full(B * Lt, self.tokenizer.pad_id, np.int32)
        attention_mask = np.zeros(B * Lt, np.int32)
        tl = np.fromiter((min(len(t), Lt) for t in texts), np.int64, B)
        if B and tl.sum():
            cum = np.concatenate([[0], np.cumsum(tl)[:-1]])
            code_of = np.repeat(np.arange(B), tl)
            flat_pos = code_of * Lt + np.arange(int(tl.sum())) - cum[code_of]
            input_ids[flat_pos] = np.concatenate([t[:Lt] for t in texts])
            attention_mask[flat_pos] = 1
        return input_ids.reshape(B, Lt), attention_mask.reshape(B, Lt)

    def __getitem__(self, idx: int) -> CodeSample:
        if idx not in self._graph_cache:
            nodes = np.sort(np.asarray(self.pkg_index_lists[idx], np.int64))
            src, dst, rel = self.kg.induced_subgraph(nodes)
            self._graph_cache[idx] = (nodes, src, dst, rel)
        nodes, src, dst, rel = self._graph_cache[idx]
        return CodeSample(
            index=idx, med_code=self.med_codes[idx],
            input_ids=np.asarray(self.text_ids(idx), np.int32),
            nodes=nodes, edge_src=src, edge_dst=dst, rel=rel,
        )


def _count_graph_fill(nodes: np.ndarray, edge_views: list, ln: int, epg: int,
                      real: int | None) -> None:
    """The graph fill counters of one built batch: the real nodes of its
    first ``real`` codes (all without) against B x Ln node slots, and for
    each view the graph encoder runs (clean, and in training the augmented
    one) their real edges against B x Epg edge slots."""
    B = len(nodes)
    real = B if real is None else real
    count("graph.nodes", int(nodes[:real].sum()))
    count("graph.node_slots", B * ln)
    for edges in edge_views:
        count("graph.edges", int(edges[:real].sum()))
        count("graph.edge_slots", B * epg)


class _NoopFence:
    """The fence of a batch that holds no pooled buffer (numpy route)."""

    def set_fence(self, device=None) -> None:  # noqa: D102
        pass


def _compress_classic(classic: CodeBatch, epg: int, *, want_aug: bool,
                      want_text: bool = True):
    """CodeBatch (numpy) -> (CompactCodeBatch, fence) in the int32
    (src << 16) | dst encoding: the numpy route's compact batch. Real edges
    come first in each graph's slots (the C++ packer and ``collate`` both
    write them so), so ne is the count of nonzero weights a graph."""
    B = classic.node_ids.shape[0]

    def compress(src, dst, w):
        valid = np.asarray(w).reshape(B, epg) > 0
        ne = valid.sum(axis=1).astype(np.int32)
        packed = np.where(valid.reshape(-1),
                          (np.asarray(src, np.int32) << 16) | np.asarray(dst, np.int32),
                          0).astype(np.int32)
        return torch.from_numpy(packed), torch.from_numpy(ne)

    edge_packed, ne = compress(classic.edge_src, classic.edge_dst, classic.edge_weight)
    edge_packed_aug = ne_aug = None
    if want_aug:
        edge_packed_aug, ne_aug = compress(classic.edge_src_aug, classic.edge_dst_aug,
                                           classic.edge_weight_aug)
    empty = np.zeros((B, 0), np.int32)
    return CompactCodeBatch(
        input_ids=torch.from_numpy(np.asarray(classic.input_ids if want_text else empty)),
        attention_mask=torch.from_numpy(
            np.asarray(classic.attention_mask if want_text else empty)),
        node_ids=torch.from_numpy(np.asarray(classic.node_ids)),
        nn=torch.from_numpy(np.asarray(classic.node_mask, np.int32).sum(axis=1,
                                                                         dtype=np.int32)),
        edge_packed=edge_packed, ne=ne, edge_packed_aug=edge_packed_aug, ne_aug=ne_aug,
        code_indices=torch.from_numpy(np.asarray(classic.code_indices)),
    ), _NoopFence()


VOCAB_COLUMNS = ("med_code", "desc", "pkg_index_list")


def write_jsonl(columns: dict, path: str | Path) -> None:
    """Write the vocabulary columns (``med_code``, ``desc``,
    ``pkg_index_list``) as JSON Lines: one object a code, in row order, the
    node lists as lists of ints."""
    with open(path, "w") as f:
        for code, desc, nodes in zip(*(columns[c] for c in VOCAB_COLUMNS)):
            f.write(json.dumps({"med_code": str(code), "desc": str(desc),
                                "pkg_index_list": [int(n) for n in nodes]}) + "\n")


def read_jsonl(path: str | Path) -> dict:
    """The vocabulary columns of a file ``write_jsonl`` wrote (blank lines
    skipped)."""
    columns: dict = {c: [] for c in VOCAB_COLUMNS}
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                for c in VOCAB_COLUMNS:
                    columns[c].append(row[c])
    return columns


def read_vocab_columns(path: str | Path, columns=("med_code", "pkg_index_list")) -> dict:
    """Columns of an all_codes_mappings vocabulary: a ``.jsonl`` (no
    pandas) or a ``.parquet`` (needs pandas and pyarrow), by suffix."""
    suffix = Path(path).suffix
    if suffix == ".jsonl":
        cols = read_jsonl(path)
        return {c: cols[c] for c in columns}
    if suffix == ".parquet":
        import pandas as pd

        df = pd.read_parquet(path, columns=list(columns))
        return {c: df[c].tolist() for c in columns}
    raise ValueError(f"{path}: the code vocabulary must be a .parquet or a .jsonl file")


def collate(
    samples: Sequence[CodeSample],
    cfg: DataConfig,
    *,
    rng: np.random.Generator | None = None,
    pad_id: int = 0,
    shapes: tuple[int, int, int] | None = None,
) -> CodeBatch:
    """Pad samples into one static-shape CodeBatch of numpy arrays.

    Buckets come from the largest text, node and edge counts of the batch,
    or ``shapes=(Lt, Ln, Epg)`` pins them; graphs beyond them are
    truncated. With ``rng`` (training)
    the augmented edges are each graph's kept edges after ``edge_dropout``
    at ``cfg.edge_dropout_p``, one draw per graph in batch order; without it
    (eval) the augmented fields alias the clean ones."""
    B = len(samples)
    if shapes is not None:
        Lt, Ln, Epg = shapes
    else:
        Lt = _pick_bucket(cfg.text_buckets, max(len(s.input_ids) for s in samples))
        Ln = _pick_bucket(cfg.node_buckets, max(len(s.nodes) for s in samples))
        Epg = _pick_bucket(cfg.edge_buckets, max(len(s.edge_src) for s in samples))

    input_ids = np.full((B, Lt), pad_id, np.int32)
    attention_mask = np.zeros((B, Lt), np.int32)
    node_ids = np.zeros((B, Ln), np.int32)
    node_mask = np.zeros((B, Ln), bool)
    E = B * Epg
    edge_src = np.zeros((E,), np.int32)
    edge_dst = np.zeros((E,), np.int32)
    edge_weight = np.zeros((E,), np.float32)
    if rng is not None:
        edge_src_aug = np.zeros((E,), np.int32)
        edge_dst_aug = np.zeros((E,), np.int32)
        edge_weight_aug = np.zeros((E,), np.float32)
    else:
        edge_src_aug, edge_dst_aug, edge_weight_aug = edge_src, edge_dst, edge_weight
    code_indices = np.asarray([s.index for s in samples], np.int32)

    for i, s in enumerate(samples):
        L = min(len(s.input_ids), Lt)
        input_ids[i, :L] = s.input_ids[:L]
        attention_mask[i, :L] = 1

        n = min(len(s.nodes), Ln)
        node_ids[i, :n] = s.nodes[:n]
        node_mask[i, :n] = True

        src, dst, rel = s.edge_src, s.edge_dst, s.rel
        if n < len(s.nodes):  # node truncation: drop edges touching cut nodes
            keep = (src < n) & (dst < n)
            src, dst, rel = src[keep], dst[keep], rel[keep]
        ne = min(len(src), Epg)
        o = i * Epg
        edge_src[o:o + ne] = src[:ne]
        edge_dst[o:o + ne] = dst[:ne]
        edge_weight[o:o + ne] = 1.0
        if rng is not None:
            a_src, a_dst, _ = edge_dropout(rng, src[:ne], dst[:ne], rel[:ne],
                                           p=cfg.edge_dropout_p)
            na = len(a_src)
            edge_src_aug[o:o + na] = a_src
            edge_dst_aug[o:o + na] = a_dst
            edge_weight_aug[o:o + na] = 1.0

    return CodeBatch(
        input_ids=input_ids, attention_mask=attention_mask,
        node_ids=node_ids, node_mask=node_mask,
        edge_src=edge_src, edge_dst=edge_dst, edge_weight=edge_weight,
        edge_src_aug=edge_src_aug, edge_dst_aug=edge_dst_aug,
        edge_weight_aug=edge_weight_aug,
        code_indices=code_indices,
    )


def epoch_batches(dataset: MedCodeDataset, *, batch_size: int, seed: int = 0,
                  epoch: int = 0, process_index: int = 0,
                  process_count: int = 1) -> Iterator[CodeBatch]:
    """One epoch of training batches, as the JAX package's iterator draws
    them: a permutation fixed by (seed, epoch), the last partial batch
    dropped, and batch bi's edge dropout seeded by ``((seed + 1) *
    1_000_003 + epoch * 65_537 + bi) * process_count + process_index``; the
    bits are drawn by ``make_batch``'s route (the C++ packer's generator on
    the native one).

    Data parallel (``process_count`` above 1): ``batch_size`` stays the
    global batch; every rank walks the same permutation and yields its
    contiguous 1 / process_count block of each global batch, padded to the
    global batch's ``batch_shapes`` so every rank's tensors have one shape."""
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} is not divisible by "
                         f"{process_count} processes")
    local_bs = batch_size // process_count
    n = len(dataset)
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    for bi, start in enumerate(range(0, n - n % batch_size, batch_size)):
        idxs = [int(i) for i in order[start:start + batch_size]]
        aug_seed = (((seed + 1) * 1_000_003 + epoch * 65_537 + bi) * process_count
                    + process_index)
        if process_count == 1:
            yield dataset.make_batch(idxs, aug_seed=aug_seed)
        else:
            yield dataset.make_batch(
                idxs[process_index * local_bs:(process_index + 1) * local_bs],
                aug_seed=aug_seed, force_shapes=dataset.batch_shapes(idxs))
