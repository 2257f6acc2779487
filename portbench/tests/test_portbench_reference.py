"""The reference against the port's CPU route at a tiny size, in fp32: the
inputs it derives (token ids, subgraphs, buckets, the edge-dropped view)
equal the program's, and the export's outputs and the training steps agree
to rounding."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.datagen import make_corpus
from portbench.reference.medtok import Inputs, dropout_keeps, wordpiece
from portbench.tests import tiny


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(dict(tiny.traffic("train")["corpus"], seed=7))


def program_dataset(corpus, cfg):
    from medtok_tpu_torch.config import DataConfig
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer

    data = DataConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg["data"].items()})
    kg = KnowledgeGraph(corpus.kg_src, corpus.kg_dst, corpus.kg_rel, {}, corpus.num_nodes)
    return MedCodeDataset(kg, corpus.med_codes, corpus.descs, corpus.node_lists,
                          WordPieceTokenizer(corpus.vocab), cfg=data)


def test_wordpiece_matches_the_program(corpus):
    from medtok_tpu_torch.data.text import WordPieceTokenizer

    tok = WordPieceTokenizer(corpus.vocab)
    for desc in corpus.descs[:200]:
        assert wordpiece(desc, corpus.vocab, 64) == tok.encode(desc, max_length=64)[0].tolist()


@pytest.mark.parametrize("aug_seed", [None, 12345, 2**40 + 3])
def test_batch_matches_the_program(corpus, aug_seed):
    cfg = tiny.config()
    ds = program_dataset(corpus, cfg)
    codes = list(range(40, 72))
    want = ds.make_batch(codes, aug_seed=aug_seed)
    got = Inputs(corpus, cfg["data"], "cpu").batch(codes, aug_seed=aug_seed)
    assert np.array_equal(got.input_ids.numpy(), want.input_ids)
    assert np.array_equal(got.text_mask.numpy(), want.attention_mask.astype(bool))
    assert np.array_equal(got.node_ids.numpy(), want.node_ids)
    assert np.array_equal(got.node_mask.numpy(), want.node_mask)
    B, Ln = want.node_ids.shape
    for edges, (src, dst, w) in ((got.edges, (want.edge_src, want.edge_dst, want.edge_weight)),
                                 (got.edges_aug, (want.edge_src_aug, want.edge_dst_aug,
                                                  want.edge_weight_aug))):
        epg = len(w) // B
        graph = np.arange(len(w)) // epg
        real = w > 0
        flat = np.stack([src[real] + graph[real] * Ln, dst[real] + graph[real] * Ln])
        assert np.array_equal(edges.numpy(), flat)


def test_dropout_stream_drops_about_p():
    keeps = dropout_keeps(99, [5000, 3000], 0.1)
    share = 1 - np.concatenate(keeps).mean()
    assert 0.08 < share < 0.12


@pytest.mark.parametrize("name", ["export-gcn", "train-gcn", "train-gat"])
def test_cell_agrees_with_the_port_in_fp32(name):
    cell = tiny.cell(name)
    res = harness.run_cell(cell, seed=2**33 + 5, seconds=0.5, trace=False, device="cpu",
                           t0=time.perf_counter())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    gaps = [k for k in checks if k.endswith("_gap")]
    assert gaps
    for k, v in checks.items():
        assert v <= (0.0 if k in ("token_gap", "fifo_gap") else 1e-4), (k, v)


def test_reference_runs_in_plain_fp32():
    assert not torch.backends.cuda.matmul.allow_tf32
