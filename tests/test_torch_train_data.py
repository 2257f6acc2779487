"""The training data path against the JAX package's numpy route, bit for
bit: edge dropout, ``collate`` with an edge-dropout generator,
``make_batch(aug_seed=)``, ``epoch_batches`` and the packing of a training
batch's texts (``pack_code_batch``)."""

import numpy as np
import pytest

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.dataset import epoch_batches as jax_epoch_batches
from medtok_tpu.data.kg import edge_dropout as jax_edge_dropout
from medtok_tpu.data.packing import pack_code_batch as jax_pack_code_batch
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu_torch.config import DataConfig
from medtok_tpu_torch.data.dataset import MedCodeDataset, collate, epoch_batches
from medtok_tpu_torch.data.kg import edge_dropout
from medtok_tpu_torch.data.packing import pack_code_batch
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab

N_CODES, KG_NODES = 40, 3000
# node buckets that truncate the largest graphs (up to 18 nodes), so collate
# drops edges touching cut nodes before the dropout draws
DATA = dict(text_buckets=(8, 16, 32, 64), node_buckets=(4, 8),
            edge_buckets=(16, 256), max_text_length=64, edge_dropout_p=0.3)


def _assert_batches_equal(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    rng = np.random.default_rng(0)
    df = synthetic_vocab_frame(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                               max_pkg_nodes=30)
    jkg = jax_synthetic_kg(rng, num_nodes=KG_NODES, num_edges=40_000, local_frac=0.8)
    df.to_parquet(root / "codes.parquet")
    jds = JaxDataset(jkg, root / "codes.parquet", JaxWordPiece(vocab),
                     cfg=JaxDataConfig(**DATA))
    jds.native = None   # the numpy route (the C++ packer draws its own bits)
    rng = np.random.default_rng(0)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=30)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=40_000, local_frac=0.8)
    ds = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                     cfg=DataConfig(**DATA))
    return ds, jds


def test_edge_dropout_matches_jax():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 50, size=(2, 200)).astype(np.int32)
    rel = rng.integers(0, 9, size=200).astype(np.int32)
    for p in (0.0, 0.1, 0.5):
        got = edge_dropout(np.random.default_rng(7), src, dst, rel, p=p)
        want = jax_edge_dropout(np.random.default_rng(7), src, dst, rel, p=p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) < 150


def test_collate_with_rng_matches_jax(datasets):
    ds, jds = datasets
    idx = [0, 5] + [i for i in range(N_CODES) if len(ds[i].nodes) > 8]
    got = collate([ds[i] for i in idx], ds.cfg, rng=np.random.default_rng(11))
    want = jax_collate([jds[i] for i in idx], jds.cfg, rng=np.random.default_rng(11))
    _assert_batches_equal(got, want)
    # the dropout removed edges, and some graphs were truncated to 8 nodes
    assert got.edge_weight_aug.sum() < got.edge_weight.sum()
    assert max(len(ds[i].nodes) for i in idx) > got.node_ids.shape[1]


def test_make_batch_aug_seed_matches_jax(datasets):
    ds, jds = datasets
    idx = list(range(3, 40, 3))
    for seed in (None, 0, 12345):
        _assert_batches_equal(ds.make_batch(idx, aug_seed=seed),
                              jds.make_batch(idx, aug_seed=seed))
    # without a seed the augmented edges are the clean ones
    clean = ds.make_batch(idx)
    np.testing.assert_array_equal(clean.edge_weight_aug, clean.edge_weight)


def test_epoch_batches_match_jax(datasets):
    ds, jds = datasets
    for kw in (dict(seed=3, epoch=0), dict(seed=3, epoch=2), dict(seed=0, epoch=1)):
        got = list(epoch_batches(ds, batch_size=8, **kw))
        want = list(jax_epoch_batches(jds, batch_size=8, **kw))
        assert len(got) == len(want) == N_CODES // 8
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_pack_code_batch_matches_jax(datasets):
    ds, _ = datasets
    b = ds.make_batch(list(range(16)), aug_seed=1)
    ids, am = np.asarray(b.input_ids), np.asarray(b.attention_mask)
    rows = int(np.ceil(am.sum() / 64)) + 2
    got = pack_code_batch(ids, am, num_rows=rows, row_len=64)
    want = jax_pack_code_batch(ids, am, shards=1, rows_per_shard=rows, row_len=64)
    _assert_batches_equal(got, want)
    assert got.gather_idx.shape == ids.shape
    # rows of 32: more rows, each fill ending on a text that does not fit
    short = am.copy()
    short[:, 32:] = 0
    rows = int(np.ceil(short.sum() / 32)) + 4
    _assert_batches_equal(
        pack_code_batch(ids, short, num_rows=rows, row_len=32),
        jax_pack_code_batch(ids, short, shards=1, rows_per_shard=rows, row_len=32))
    with pytest.raises(ValueError, match="rows"):
        pack_code_batch(ids, am, num_rows=1, row_len=64)
    with pytest.raises(ValueError, match="longer than row_len"):
        pack_code_batch(ids, am, num_rows=rows, row_len=int(am.sum(1).max()) - 1)
