"""The benchmark's one general data generator: a seeded code vocabulary and
knowledge graph at the sizes a traffic file gives.

The draws follow the synthetic heavy-tail vocabulary the project's chip
checks use (lognormal description lengths, geometric subgraph sizes with a
share of codes at 17-128 and 129-512 nodes, contiguous node runs with a
random stride, a graph whose edges are partly local), copied here so that
later changes to the program's own fixtures cannot move the yardstick.
Everything is raw input: strings, node lists and edge arrays. The program
and the reference each derive what they need from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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

# rare words are 2-3 syllable compounds; the vocabulary holds each syllable
# and its '##' continuation, so WordPiece splits them into 2-3 tokens
SYLLABLES = [
    "card", "neph", "gastr", "hepat", "derm", "pulmon", "arthr", "oste",
    "cyt", "hemo", "lymph", "scler", "fibro", "myel", "neur", "angi",
    "bronch", "cephal", "chondr", "colo", "encephal", "gloss", "myo",
    "phleb", "pleur", "rhin", "thromb", "vasc",
    "itis", "osis", "emia", "oma", "pathy", "ectomy", "plasty", "scopy",
    "gram", "logy", "lysis", "trophy", "algia", "penia", "rrhea", "stasis",
]

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def wordpiece_vocab() -> dict[str, int]:
    """The WordPiece vocabulary of the benchmark's descriptions: the special
    tokens, the whole words and syllables, single characters and their
    continuations, then the syllables' continuations."""
    vocab: dict[str, int] = {}
    for t in SPECIAL_TOKENS + tuple(MEDICAL_WORDS) + tuple(SYLLABLES):
        vocab.setdefault(t, len(vocab))
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,-":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault("##" + c, len(vocab))
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    return vocab


@dataclass
class Corpus:
    """Raw inputs of a cell: the code vocabulary's columns and the KG."""

    med_codes: list[str]
    descs: list[str]
    node_lists: list[np.ndarray]      # sorted, unique global node ids a code
    kg_src: np.ndarray                # [E] int64
    kg_dst: np.ndarray                # [E] int64
    kg_rel: np.ndarray                # [E] int32
    num_nodes: int
    vocab: dict[str, int]

    def __len__(self) -> int:
        return len(self.med_codes)


def make_corpus(spec: dict) -> Corpus:
    """The vocabulary and KG of a traffic file's ``corpus`` block, drawn
    from its own ``seed``: one fixed vocabulary for every run, as a
    deployment has one. A run's seed draws the order its codes are served
    in, the weights and the sample checked, so every seed gets the same set
    of sizes in another order."""
    rng = np.random.default_rng(spec["seed"])
    n = int(spec["codes"])
    num_nodes = int(spec["kg_nodes"])
    d = spec["desc_words"]
    syl = np.array(SYLLABLES)
    extra = ["".join(rng.choice(syl, size=int(k)))
             for k in rng.integers(2, 4, size=int(spec["extra_words"]))]
    pool = np.array(MEDICAL_WORDS + extra)
    lens = np.clip(rng.lognormal(d["mean"], d["sigma"], n).astype(np.int64),
                   d["min"], d["max"])
    offs = np.concatenate([[0], np.cumsum(lens)])
    words = pool[rng.integers(0, len(pool), size=int(offs[-1]))]
    descs = [" ".join(words[offs[i]:offs[i + 1]]) for i in range(n)]

    g = spec["nodes"]
    sizes = np.clip(rng.geometric(g["geometric_p"], n), 1, g["max_small"])
    r = rng.random(n)
    # each tier takes the codes below the summed shares of it and the tiers
    # after it, so later (rarer) tiers overwrite earlier ones
    tiers = g["tiers"]
    for i, (_, lo, hi) in enumerate(tiers):
        below = sum(t[0] for t in tiers[i:])
        sizes = np.where(r < below, rng.integers(lo, hi + 1, n), sizes)
    strides = rng.integers(1, 5, n)
    span = np.maximum(num_nodes - strides * (sizes - 1), 1)
    starts = (rng.random(n) * span).astype(np.int64)
    node_lists = [starts[i] + strides[i] * np.arange(sizes[i], dtype=np.int64)
                  for i in range(n)]

    k = spec["kg"]
    ne = int(k["edges"])
    src = rng.integers(0, num_nodes, ne)
    dst = rng.integers(0, num_nodes, ne)
    off = rng.integers(-k["local_window"], k["local_window"] + 1, ne)
    dst = np.where(rng.random(ne) < k["local_share"], (src + off) % num_nodes, dst)
    rel = rng.integers(0, k["relations"], ne).astype(np.int32)
    return Corpus(med_codes=[f"C{i:06d}" for i in range(n)], descs=descs,
                  node_lists=node_lists, kg_src=src.astype(np.int64),
                  kg_dst=dst.astype(np.int64), kg_rel=rel, num_nodes=num_nodes,
                  vocab=wordpiece_vocab())
