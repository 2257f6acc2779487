"""Knowledge graph as edge arrays + CSR, the edge dropout of the training
view, and the typed ``HeteroKG`` view (own copy of
``medtok_tpu/data/kg.py``).

Built from arrays; the ``from_csv`` readers take a PrimeKG ``kg.csv`` with
the ``csv`` module (no pandas, which the port does not require).
"""

from __future__ import annotations

import csv
import operator
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class KnowledgeGraph:
    edge_src: np.ndarray      # [E] int64 x_index
    edge_dst: np.ndarray      # [E] int64 y_index
    rel_index: np.ndarray     # [E] int32 display_relation vocab id
    rel_vocab: dict[str, int]
    num_nodes: int
    _indptr: np.ndarray | None = None
    _order: np.ndarray | None = None  # edge permutation sorting by src

    @classmethod
    def from_csv(cls, kg_path: str | Path) -> "KnowledgeGraph":
        """Read kg.csv (columns x_index, y_index, display_relation, in any
        position among the others; quoted fields as the csv module reads
        them); accepts the file or the directory holding it. The relation
        vocabulary is in order of first appearance, as the JAX package's
        pandas reader builds it."""
        p = Path(kg_path)
        if p.is_dir():
            p = p / "kg.csv"
        columns = _read_columns(p, ("x_index", "y_index", "display_relation"))
        src = np.array(columns[0], dtype=np.int64)
        dst = np.array(columns[1], dtype=np.int64)
        rel_vocab: dict[str, int] = {}
        codes = np.fromiter((rel_vocab.setdefault(r, len(rel_vocab)) for r in columns[2]),
                            dtype=np.int32, count=len(columns[2]))
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        return cls(src, dst, codes, rel_vocab, num_nodes)

    def _build_csr(self) -> None:
        self._order = np.argsort(self.edge_src, kind="stable")
        counts = np.bincount(self.edge_src, minlength=self.num_nodes)
        indptr = np.zeros(self.num_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        self._indptr = indptr

    def induced_subgraph(
        self, nodes: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Edges with both endpoints in ``nodes``, relabelled to positions in
        the sorted node list (PyG ``subgraph(relabel_nodes=True)``).

        Returns (local_src, local_dst, rel) int32 arrays."""
        if self._indptr is None:
            self._build_csr()
        nodes = np.sort(np.asarray(nodes, np.int64))
        spans = [
            self._order[self._indptr[n]:self._indptr[n + 1]]
            for n in nodes
            if n < self.num_nodes
        ]
        if not spans:
            z = np.zeros(0, np.int32)
            return z, z, z
        cand = np.concatenate(spans)
        dsts = self.edge_dst[cand]
        pos = np.clip(np.searchsorted(nodes, dsts), 0, len(nodes) - 1)
        keep = nodes[pos] == dsts
        cand = cand[keep]
        local_dst = pos[keep].astype(np.int32)
        local_src = np.searchsorted(nodes, self.edge_src[cand]).astype(np.int32)
        rel = self.rel_index[cand].astype(np.int32)
        return local_src, local_dst, rel


def _read_columns(p: Path, names: tuple[str, ...]) -> list[tuple[str, ...]]:
    """The ``names`` columns of a csv file as tuples of strings, in any
    position among the others."""
    with open(p, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        try:
            cols = [header.index(c) for c in names]
        except ValueError:
            raise ValueError(f"{p}: kg.csv needs the columns {', '.join(names)}, "
                             f"found {header}") from None
        return list(zip(*map(operator.itemgetter(*cols), reader))) or [()] * len(names)


@dataclass
class HeteroKG:
    """The typed PrimeKG view (not on the training path): each node's type
    and its index among the nodes of that type, and the edges grouped by
    (x_type, relation, y_type) in type-local indices, with an ``.npz``
    cache in the JAX package's layout (each package reads the other's)."""

    # node_index -> node type, and -> its index within the type
    node_type: dict[int, str]
    node_type_graph_index: dict[int, int]
    # (x_type, relation, y_type) -> (src_local [E], dst_local [E]) int64
    edge_groups: dict[tuple[str, str, str], tuple[np.ndarray, np.ndarray]]

    @classmethod
    def from_csv(cls, kg_path: str | Path, cache_path: str | Path | None = None) -> "HeteroKG":
        """Read kg.csv (the file or its directory), or ``cache_path`` when
        it exists (written there otherwise). The JAX reader's pandas order:
        nodes in first appearance over all x_index rows, then all y_index
        rows, each taking the type of its first row; the type-local index
        counts the nodes of its type so far; edge groups in first appearance
        of their (x_type, relation, y_type). Type and relation values are
        the file's strings."""
        if cache_path is not None and Path(cache_path).exists():
            return cls._load(cache_path)
        p = Path(kg_path)
        if p.is_dir():
            p = p / "kg.csv"
        xi, xt, rel, yi, yt = _read_columns(
            p, ("x_index", "x_type", "relation", "y_index", "y_type"))
        xi, yi = [int(i) for i in xi], [int(i) for i in yi]
        node_type: dict[int, str] = {}
        for i, t in zip(xi + yi, xt + yt):
            node_type.setdefault(i, t)
        counts: dict[str, int] = {}
        local: dict[int, int] = {}
        for i, t in node_type.items():
            local[i] = counts.get(t, 0)
            counts[t] = local[i] + 1
        rows: dict[tuple[str, str, str], list[int]] = {}
        for r, key in enumerate(zip(xt, rel, yt)):
            rows.setdefault(key, []).append(r)
        edge_groups = {
            key: (np.asarray([local[xi[r]] for r in rs], np.int64),
                  np.asarray([local[yi[r]] for r in rs], np.int64))
            for key, rs in rows.items()}
        kg = cls(node_type, local, edge_groups)
        if cache_path is not None:
            kg._save(cache_path)
        return kg

    def num_nodes(self, ntype: str) -> int:
        return sum(1 for t in self.node_type.values() if t == ntype)

    def num_edges(self) -> int:
        return sum(len(s) for s, _ in self.edge_groups.values())

    def get_type_graph_index(self, org_idx: int) -> int:
        return self.node_type_graph_index[org_idx]

    def _save(self, path: str | Path) -> None:
        arrays = {}
        for i, (s, d) in enumerate(self.edge_groups.values()):
            arrays[f"src_{i}"] = s
            arrays[f"dst_{i}"] = d
        meta = {
            "keys": list(self.edge_groups),
            "node_index": list(self.node_type),
            "node_type": list(self.node_type.values()),
            "local": list(self.node_type_graph_index.values()),
        }
        np.savez_compressed(path, meta=np.asarray([repr(meta)]), **arrays)

    @classmethod
    def _load(cls, path: str | Path) -> "HeteroKG":
        import ast

        with np.load(path, allow_pickle=False) as z:
            meta = ast.literal_eval(str(z["meta"][0]))
            groups = {tuple(k): (z[f"src_{i}"], z[f"dst_{i}"])
                      for i, k in enumerate(meta["keys"])}
        return cls(dict(zip(meta["node_index"], meta["node_type"])),
                   dict(zip(meta["node_index"], meta["local"])), groups)


def edge_dropout(
    rng: np.random.Generator, src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
    p: float = 0.1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop each edge with probability p (one uniform draw per edge from
    ``rng``, kept where it exceeds p): the training view's augmentation."""
    keep = rng.random(len(src)) > p
    return src[keep], dst[keep], rel[keep]
