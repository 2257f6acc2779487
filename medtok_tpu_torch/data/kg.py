"""Knowledge graph as edge arrays + CSR (own copy of the array part of
``medtok_tpu/data/kg.py``).

Built from arrays; ``from_csv`` reads a PrimeKG ``kg.csv`` and is the only
function here that needs pandas, which it imports when called.
"""

from __future__ import annotations

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
        """Read kg.csv (columns x_index, y_index, display_relation); accepts
        the file or the directory holding it."""
        import pandas as pd

        p = Path(kg_path)
        if p.is_dir():
            p = p / "kg.csv"
        df = pd.read_csv(p, usecols=["x_index", "y_index", "display_relation"],
                         low_memory=False)
        src = df["x_index"].to_numpy(np.int64)
        dst = df["y_index"].to_numpy(np.int64)
        rels = df["display_relation"].to_numpy()
        rel_vocab: dict[str, int] = {}
        codes = np.empty(len(rels), np.int32)
        for i, r in enumerate(rels):
            if r not in rel_vocab:
                rel_vocab[r] = len(rel_vocab)
            codes[i] = rel_vocab[r]
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
