"""MedCodeDataset, the static-shape bucketing collator and the shuffled
epoch iterator (numpy path of ``medtok_tpu/data/dataset.py``).

One sample per medical code: the tokenized description plus the code's
induced KG subgraph. The dataset is built from in-memory columns
(``med_code``, ``desc``, ``pkg_index_list``); ``from_path`` reads them from
an all_codes_mappings ``.parquet`` (through pandas, which the GPU machine
lacks) or from a ``.jsonl`` copy of the same three columns, one JSON object
a line (the ``json`` module; ``write_jsonl`` writes one). JSON Lines is only
a container for the same columns: both give the same dataset.
Training batches carry an edge-dropped copy of each graph, drawn from a
numpy generator seeded per batch, bit for bit the JAX package's numpy route.
The C++ ctypes runtime and the compact batch encoding of the JAX package are
host-transfer optimisations that this port does not have yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from medtok_tpu_torch.config import DataConfig
from medtok_tpu_torch.data.kg import KnowledgeGraph, edge_dropout
from medtok_tpu_torch.data.packing import pack_store_meta
from medtok_tpu_torch.data.text import WordPieceTokenizer
from medtok_tpu_torch.data.types import CodeBatch


@dataclass
class CodeSample:
    index: int
    med_code: str
    input_ids: np.ndarray       # [L] unpadded
    nodes: np.ndarray           # sorted global KG node ids
    edge_src: np.ndarray        # local indices into nodes
    edge_dst: np.ndarray
    rel: np.ndarray


def _pick_bucket(buckets: Sequence[int], needed: int) -> int:
    for b in buckets:
        if needed <= b:
            return b
    return buckets[-1]


class _TextStore:
    """Tokenized descriptions: one flat growable arena + per-row
    (start, length) vectors."""

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

    def put_one(self, i: int, ids: np.ndarray) -> None:
        need = self.tail + len(ids)
        if need > len(self.arena):
            arena = np.empty(max(need, 2 * len(self.arena)), self.dtype)
            arena[: self.tail] = self.arena[: self.tail]
            self.arena = arena
        self.arena[self.tail:need] = ids
        self.start[i] = self.tail
        self.length[i] = len(ids)
        self.tail = need


class MedCodeDataset:
    """The code vocabulary + KG, serving CodeSamples and padded batches."""

    def __init__(
        self,
        kg: KnowledgeGraph,
        med_codes: Sequence[str],
        descs: Sequence[str],
        pkg_index_lists: Sequence,
        tokenizer: WordPieceTokenizer,
        *,
        cfg: DataConfig = DataConfig(),
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
        self._code_index: dict[str, int] | None = None

    @classmethod
    def from_columns(cls, kg: KnowledgeGraph, columns: dict, tokenizer, *,
                     cfg: DataConfig = DataConfig()) -> "MedCodeDataset":
        return cls(kg, columns["med_code"], columns["desc"],
                   columns["pkg_index_list"], tokenizer, cfg=cfg)

    @classmethod
    def from_parquet(cls, kg: KnowledgeGraph, path: str | Path, tokenizer, *,
                     cfg: DataConfig = DataConfig()) -> "MedCodeDataset":
        """Read an all_codes_mappings parquet (needs pandas + pyarrow)."""
        import pandas as pd

        df = pd.read_parquet(path)
        return cls(kg, df["med_code"].tolist(), df["desc"].tolist(),
                   df["pkg_index_list"].tolist(), tokenizer, cfg=cfg)

    @classmethod
    def from_path(cls, kg: KnowledgeGraph, path: str | Path, tokenizer, *,
                  cfg: DataConfig = DataConfig()) -> "MedCodeDataset":
        """Read the vocabulary columns from a ``.parquet`` (needs pandas and
        pyarrow) or a ``.jsonl`` file, by its suffix."""
        suffix = Path(path).suffix
        if suffix == ".parquet":
            return cls.from_parquet(kg, path, tokenizer, cfg=cfg)
        if suffix == ".jsonl":
            return cls.from_columns(kg, read_jsonl(path), tokenizer, cfg=cfg)
        raise ValueError(f"{path}: the code vocabulary must be a .parquet or a .jsonl "
                         "file")

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

    def warm_cache(self) -> None:
        """Tokenize every description (the host half of the export sweep)."""
        for i in self._text.missing(np.arange(len(self))):
            self.text_ids(int(i))

    def text_lengths(self, lo: int, hi: int) -> np.ndarray:
        """Token counts of rows [lo, hi) (rows must be tokenized already)."""
        return self._text.length[lo:hi].astype(np.int64)

    def pack_text_rows(self, indices, *, row_len: int, num_rows: int):
        """Pack the tokenized descriptions of ``indices`` into fixed
        [num_rows, row_len] rows. Returns (input_ids, flat_base, lens)."""
        t = self._text
        return pack_store_meta(
            t.arena, t.start, t.length, np.asarray(indices, np.int64),
            row_len=row_len, num_rows=num_rows,
        )

    def text_ids(self, idx: int) -> np.ndarray:
        if idx not in self._text:
            ids, _ = self.tokenizer.encode(
                str(self.descs[idx]), max_length=self.cfg.max_text_length
            )
            self._text.put_one(idx, ids)
        return self._text.get(idx)

    def make_batch(self, indices: Sequence[int], *,
                   aug_seed: int | None = None) -> CodeBatch:
        """CodeBatch of these codes, bucketed by ``collate``. ``aug_seed``
        (training) seeds the numpy generator of the edge dropout; without
        it the augmented edges are the clean ones."""
        rng = np.random.default_rng(aug_seed) if aug_seed is not None else None
        return collate([self[int(i)] for i in indices], self.cfg, rng=rng,
                       pad_id=self.tokenizer.pad_id)

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


def collate(
    samples: Sequence[CodeSample],
    cfg: DataConfig,
    *,
    rng: np.random.Generator | None = None,
    pad_id: int = 0,
) -> CodeBatch:
    """Pad samples into one static-shape CodeBatch of numpy arrays.

    Buckets come from the largest text, node and edge counts of the batch;
    graphs beyond the largest bucket are truncated. With ``rng`` (training)
    the augmented edges are each graph's kept edges after ``edge_dropout``
    at ``cfg.edge_dropout_p``, one draw per graph in batch order; without it
    (eval) the augmented fields alias the clean ones."""
    B = len(samples)
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
                  epoch: int = 0) -> Iterator[CodeBatch]:
    """One epoch of training batches: a permutation fixed by (seed, epoch),
    the last partial batch dropped, and batch bi's edge dropout seeded by
    ``(seed + 1) * 1_000_003 + epoch * 65_537 + bi``, as the JAX package's
    single-process iterator shuffles and seeds them."""
    n = len(dataset)
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    for bi, start in enumerate(range(0, n - n % batch_size, batch_size)):
        aug_seed = (seed + 1) * 1_000_003 + epoch * 65_537 + bi
        yield dataset.make_batch([int(i) for i in order[start:start + batch_size]],
                                 aug_seed=aug_seed)
