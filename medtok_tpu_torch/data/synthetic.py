"""Synthetic fixtures (counterpart of ``medtok_tpu/data/synthetic.py``):
random CodeBatches, reference-schema ``kg.csv`` and vocabulary files, and
the vocabulary and KG at production scale.

The draws are the JAX package's, in the same order, so the same seeded
generator yields the same batches, rows, codes, descriptions and node
lists. No pandas: the kg.csv is written by the ``csv`` module as pandas'
``to_csv(index=False)`` writes it (the same bytes), the vocabulary as
``.jsonl`` (or ``.parquet`` where pandas is installed), and the
production-scale vocabulary comes back as plain columns instead of a
DataFrame.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from medtok_tpu_torch.data.dataset import VOCAB_COLUMNS, write_jsonl
from medtok_tpu_torch.data.kg import KnowledgeGraph
from medtok_tpu_torch.data.types import CodeBatch


def random_code_batch(
    rng: np.random.Generator,
    *,
    batch: int = 8,
    text_len: int = 32,
    max_nodes: int = 16,
    max_edges_per_graph: int = 32,
    text_vocab: int = 30522,
    num_kg_nodes: int = 130000,
    edge_dropout_p: float = 0.1,
) -> CodeBatch:
    """A random, well-formed CodeBatch of numpy arrays: ragged texts and
    graphs padded to (text_len, max_nodes, max_edges_per_graph), graph i's
    edges in slots [i * Epg, i * Epg + ne) with within-graph node indices,
    and the augmented edges an independent edge dropout of them."""
    B, Lt, Ln = batch, text_len, max_nodes
    E = batch * max_edges_per_graph

    text_lens = rng.integers(4, Lt + 1, size=B)
    input_ids = np.zeros((B, Lt), np.int32)
    attention_mask = np.zeros((B, Lt), np.int32)
    for i, L in enumerate(text_lens):
        input_ids[i, :L] = rng.integers(1, text_vocab, size=L)
        attention_mask[i, :L] = 1

    node_counts = rng.integers(1, Ln + 1, size=B)
    node_ids = np.zeros((B, Ln), np.int32)
    node_mask = np.zeros((B, Ln), bool)
    for i, n in enumerate(node_counts):
        node_ids[i, :n] = rng.choice(num_kg_nodes, size=n, replace=False)
        node_mask[i, :n] = True

    edge_src = np.zeros((E,), np.int32)
    edge_dst = np.zeros((E,), np.int32)
    edge_weight = np.zeros((E,), np.float32)
    Epg = max_edges_per_graph
    for i, n in enumerate(node_counts):
        ne = int(rng.integers(0, Epg + 1)) if n > 1 else 0
        if ne:
            edge_src[i * Epg:i * Epg + ne] = rng.integers(0, n, size=ne)
            edge_dst[i * Epg:i * Epg + ne] = rng.integers(0, n, size=ne)
            edge_weight[i * Epg:i * Epg + ne] = 1.0
    keep = (rng.random(E) > edge_dropout_p) & (edge_weight > 0)
    edge_weight_aug = np.where(keep, edge_weight, 0.0).astype(np.float32)

    return CodeBatch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        node_ids=node_ids,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_weight=edge_weight,
        edge_src_aug=edge_src.copy(),
        edge_dst_aug=edge_dst.copy(),
        edge_weight_aug=edge_weight_aug,
        code_indices=np.arange(B, dtype=np.int32),
    )


KG_RELATIONS = ["ppi", "carrier", "enzyme", "target", "transporter", "indication"]
KG_NODE_TYPES = ["gene/protein", "drug", "disease", "effect/phenotype"]


def synthetic_kg_csv(
    path: str | Path, rng: np.random.Generator, *, num_nodes: int = 500,
    num_edges: int = 4000,
) -> None:
    """Write a PrimeKG-schema kg.csv (relation, display_relation, and the
    index / id / type / name / source of x and y), a node's type by its
    index."""
    x = rng.integers(0, num_nodes, size=num_edges)
    y = rng.integers(0, num_nodes, size=num_edges)
    r = rng.integers(0, len(KG_RELATIONS), size=num_edges)
    types = KG_NODE_TYPES
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["relation", "display_relation", "x_index", "x_id", "x_type", "x_name",
                    "x_source", "y_index", "y_id", "y_type", "y_name", "y_source"])
        for xi, yi, ri in zip(x.tolist(), y.tolist(), r.tolist()):
            rel = KG_RELATIONS[ri]
            w.writerow([rel, rel, xi, xi, types[xi % len(types)], f"node_{xi}", "synthetic",
                        yi, yi, types[yi % len(types)], f"node_{yi}", "synthetic"])


CODE_WORDS = ["diabetes", "mellitus", "acute", "chronic", "infection", "fracture",
              "hypertension", "renal", "cardiac", "therapy", "syndrome", "disorder"]


def synthetic_code_vocab(
    path: str | Path, rng: np.random.Generator, *, num_codes: int = 64,
    num_nodes: int = 500,
) -> None:
    """Write an all_codes_mappings-schema vocabulary (med_code / desc /
    pkg_index_list): 1-8 distinct nodes and 2-7 words a code. A ``.jsonl``
    path gets JSON Lines (``data/dataset.py::write_jsonl``), a ``.parquet``
    one a parquet file (needs pandas and pyarrow), as the readers choose by
    suffix."""
    suffix = Path(path).suffix
    if suffix not in (".jsonl", ".parquet"):
        raise ValueError(f"{path}: the code vocabulary must be a .parquet or a .jsonl file")
    columns: dict[str, list] = {c: [] for c in VOCAB_COLUMNS}
    for i in range(num_codes):
        n = int(rng.integers(1, 9))
        nodes = rng.choice(num_nodes, size=n, replace=False).tolist()
        desc = " ".join(rng.choice(CODE_WORDS, size=int(rng.integers(2, 8))).tolist())
        columns["med_code"].append(f"C{i:05d}")
        columns["desc"].append(desc)
        columns["pkg_index_list"].append(nodes)
    if suffix == ".jsonl":
        write_jsonl(columns, path)
    else:
        import pandas as pd

        pd.DataFrame(columns).to_parquet(path)

MEDICAL_WORDS = [
    "diabetes", "mellitus", "acute", "chronic", "infection", "fracture",
    "hypertension", "renal", "cardiac", "therapy", "syndrome", "disorder",
    "unspecified", "type", "without", "with", "complications", "disease",
    "malignant", "neoplasm", "left", "right", "injury", "of", "the", "and",
    "due", "to", "encounter", "screening", "examination", "failure",
    "obstruction", "bilateral", "initial", "subsequent", "sequela",
    "poisoning", "adverse", "effect", "tablet", "oral", "solution",
    "personal", "history", "body", "region", "severe", "moderate", "mild",
]

# Rare words are 2-3 syllable compounds; a vocab holding each syllable and
# its '##' continuation splits them into 2-3 WordPiece tokens.
SYLLABLES = [
    "card", "neph", "gastr", "hepat", "derm", "pulmon", "arthr", "oste",
    "cyt", "hemo", "lymph", "scler", "fibro", "myel", "neur", "angi",
    "bronch", "cephal", "chondr", "colo", "encephal", "gloss", "myo",
    "phleb", "pleur", "rhin", "thromb", "vasc",
    "itis", "osis", "emia", "oma", "pathy", "ectomy", "plasty", "scopy",
    "gram", "logy", "lysis", "trophy", "algia", "penia", "rrhea", "stasis",
]


def synthetic_vocab_columns(
    rng: np.random.Generator,
    *,
    num_codes: int,
    num_kg_nodes: int = 130_000,
    extra_words: int = 200,
    max_pkg_nodes: int = 16,
    heavy_tail: bool = False,
) -> dict[str, list]:
    """``med_code`` / ``desc`` / ``pkg_index_list`` columns of an
    all_codes_mappings-schema vocabulary.

    Description lengths are lognormal (mean ~7 words). ``heavy_tail`` puts
    ~9% of codes at 17..128 nodes and ~3% at 129..512, so the 128 and 512
    node buckets carry real traffic."""
    syl = np.array(SYLLABLES)
    extra = [
        "".join(rng.choice(syl, size=int(n)))
        for n in rng.integers(2, 4, size=extra_words)
    ]
    pool = np.array(MEDICAL_WORDS + extra)

    lens = np.clip(rng.lognormal(1.9, 0.5, num_codes).astype(np.int64), 2, 40)
    offs = np.concatenate([[0], np.cumsum(lens)])
    widx = rng.integers(0, len(pool), size=int(offs[-1]))
    descs = [" ".join(pool[widx[offs[i]:offs[i + 1]]]) for i in range(num_codes)]

    sizes = np.clip(rng.geometric(0.25, num_codes), 1, max_pkg_nodes)
    if heavy_tail:
        r = rng.random(num_codes)
        sizes = np.where(r < 0.12, rng.integers(17, 129, num_codes), sizes)
        sizes = np.where(r < 0.03, rng.integers(129, 513, num_codes), sizes)
    # contiguous node runs with a random stride: unique and sorted
    strides = rng.integers(1, 5, num_codes)
    span = np.maximum(num_kg_nodes - strides * (sizes - 1), 1)
    starts = (rng.random(num_codes) * span).astype(np.int64)
    pkg = [starts[i] + strides[i] * np.arange(sizes[i]) for i in range(num_codes)]
    return {
        "med_code": [f"C{i:06d}" for i in range(num_codes)],
        "desc": descs,
        "pkg_index_list": pkg,
    }


def synthetic_kg(
    rng: np.random.Generator, *, num_nodes: int = 130_000,
    num_edges: int = 4_000_000, num_relations: int = 20,
    local_frac: float = 0.0, local_window: int = 64,
) -> KnowledgeGraph:
    """A PrimeKG-scale graph built directly from arrays. ``local_frac`` makes
    that share of edges local (dst within +-local_window of src), so code
    subgraphs carry real edges as PrimeKG neighbourhoods do."""
    src = rng.integers(0, num_nodes, num_edges)
    dst = rng.integers(0, num_nodes, num_edges)
    if local_frac > 0:
        off = rng.integers(-local_window, local_window + 1, num_edges)
        dst = np.where(
            rng.random(num_edges) < local_frac, (src + off) % num_nodes, dst,
        )
    rel = rng.integers(0, num_relations, num_edges).astype(np.int32)
    vocab = {f"rel_{i}": i for i in range(num_relations)}
    return KnowledgeGraph(src, dst, rel, vocab, num_nodes)
