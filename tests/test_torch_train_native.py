"""The training data path on the native route (the default): the port's
``epoch_batches`` draws its edge-dropout bits in the C++ packer, so its
batches are bit for bit the JAX package's default (native) route's, over
two epochs with edge dropout. The numpy route (``native=False``) packs the
same graphs, compared graph by graph with the padding trimmed, and draws
other dropout bits; before the native route the port's training batches
were only the JAX package's numpy route's."""

import numpy as np
import pandas as pd
import pytest

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import epoch_batches as jax_epoch_batches
from medtok_tpu.data.kg import KnowledgeGraph as JaxKG
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu_torch.config import DataConfig
from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab

N_CODES, KG_NODES = 48, 3000
# node buckets that cut the largest graphs; edge buckets the native route grows
DATA = dict(text_buckets=(8, 16, 32, 64), node_buckets=(4, 8, 16),
            edge_buckets=(4, 8, 16, 64), max_text_length=64, edge_dropout_p=0.3)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_native")
    rng = np.random.default_rng(4)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=30)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=40_000, local_frac=0.8)
    pd.DataFrame({"med_code": cols["med_code"], "desc": cols["desc"],
                  "pkg_index_list": [[int(x) for x in n] for n in cols["pkg_index_list"]]}
                 ).to_parquet(root / "codes.parquet")
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    jkg = JaxKG(kg.edge_src, kg.edge_dst, kg.rel_index, dict(kg.rel_vocab), kg.num_nodes)
    jds = JaxDataset(jkg, root / "codes.parquet", JaxWordPiece(vocab), cfg=JaxDataConfig(**DATA))
    assert jds.native is not None      # the JAX package's default route
    ds = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab), cfg=DataConfig(**DATA))
    ds_np = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                        cfg=DataConfig(**DATA), native=False)
    return ds, ds_np, jds


def _epochs(fn, ds, seed):
    return [b for epoch in (0, 1) for b in fn(ds, batch_size=8, seed=seed, epoch=epoch)]


@pytest.mark.parametrize("seed", [0, 7])
def test_epoch_batches_match_jax_default_route(datasets, seed):
    ds, _, jds = datasets
    got, want = _epochs(epoch_batches, ds, seed), _epochs(jax_epoch_batches, jds, seed)
    assert len(got) == len(want) == 2 * (N_CODES // 8)
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    kept = sum(float(b.edge_weight_aug.sum()) for b in got)
    assert 0 < kept < sum(float(b.edge_weight.sum()) for b in got)
    # some batch grew its edge bucket past the one paired with its nodes
    assert any(b.edge_src.shape[0] // 8 > DATA["edge_buckets"][DATA["node_buckets"].index(
        b.node_ids.shape[1])] for b in got)


def _graphs(batch):
    """Per graph: (node ids, clean edge list, augmented edge list), padding
    trimmed."""
    B = batch.node_ids.shape[0]
    out = []
    for i in range(B):
        n = int(batch.node_mask[i].sum())
        per = []
        for s, d, w in ((batch.edge_src, batch.edge_dst, batch.edge_weight),
                        (batch.edge_src_aug, batch.edge_dst_aug, batch.edge_weight_aug)):
            s, d, w = (x.reshape(B, -1)[i] for x in (s, d, w))
            per.append(np.stack([s[w > 0], d[w > 0]]))
        out.append((batch.node_ids[i, :n], *per))
    return out


def test_numpy_route_packs_the_same_graphs_with_other_dropout_bits(datasets):
    ds, ds_np, _ = datasets
    got, want = _epochs(epoch_batches, ds, 3), _epochs(epoch_batches, ds_np, 3)
    differ = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.code_indices, w.code_indices)
        np.testing.assert_array_equal(g.input_ids, w.input_ids)
        for (gn, ge, ga), (wn, we, wa) in zip(_graphs(g), _graphs(w)):
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(ge, we)
            differ += not np.array_equal(ga, wa)
    assert differ > 0
