"""Synthetic vocabulary and KG at production scale (numpy versions of
``medtok_tpu/data/synthetic.py::synthetic_vocab_frame`` / ``synthetic_kg``).

The draws are the JAX package's, in the same order, so the same seeded
generator yields the same codes, descriptions and node lists; the vocabulary
comes back as plain columns instead of a DataFrame.
"""

from __future__ import annotations

import numpy as np

from medtok_tpu_torch.data.kg import KnowledgeGraph

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
