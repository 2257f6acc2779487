"""The compact batches of the port (``make_batch_compact`` +
``data/compact.py::unpack_compact``) and the dataset's host half:

- the port's unpacked compact batch equals its ``make_batch`` on the same
  route (native, and numpy through ``_compress_classic``);
- the port's compact batch and its expansion equal the JAX package's
  (``make_batch_compact`` + its ``unpack_compact`` run eagerly) for each
  edge encoding, with and without edge dropout, under ``force_shapes`` and
  with edge-bucket growth;
- the node arena of ``warm_cache`` (unsorted rows repaired) and the
  ``cache_dir`` text cache, with its guard against narrowing ids, as the
  JAX package builds and reads them."""

import numpy as np
import pandas as pd
import pytest
import torch

import medtok_tpu.data.dataset as jax_dataset_module
from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.compact import unpack_compact as jax_unpack_compact
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.kg import KnowledgeGraph as JaxKG
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu_torch.config import DataConfig
from medtok_tpu_torch.data import dataset as dataset_module
from medtok_tpu_torch.data.compact import unpack_compact
from medtok_tpu_torch.data.dataset import MedCodeDataset
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab

N_CODES, KG_NODES = 160, 4000
DATA = dict(text_buckets=(8, 16, 32, 64), node_buckets=(8, 16, 128, 512),
            edge_buckets=(4, 16, 1024, 8192), max_text_length=64, edge_dropout_p=0.2)


def _vocab():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    return vocab


def _columns():
    rng = np.random.default_rng(11)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=16, heavy_tail=True)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=80_000, local_frac=0.8)
    # one row out of order with a repeat, one empty (warm_cache repairs /
    # keeps them as the JAX package does)
    cols["pkg_index_list"][5] = np.array([900, 12, 400, 12, 7])
    cols["pkg_index_list"][6] = np.array([], np.int64)
    return cols, kg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("compact")
    cols, kg = _columns()
    pd.DataFrame({"med_code": cols["med_code"], "desc": cols["desc"],
                  "pkg_index_list": [[int(x) for x in n] for n in cols["pkg_index_list"]]}
                 ).to_parquet(root / "codes.parquet")
    jkg = JaxKG(kg.edge_src, kg.edge_dst, kg.rel_index, dict(kg.rel_vocab), kg.num_nodes)
    vocab = _vocab()
    jds = JaxDataset(jkg, root / "codes.parquet", JaxWordPiece(vocab),
                     cfg=JaxDataConfig(**DATA))
    assert jds.native is not None      # the JAX package's default route
    ds = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab), cfg=DataConfig(**DATA))
    ds_np = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                        cfg=DataConfig(**DATA), native=False)
    sizes = np.array([len(n) for n in cols["pkg_index_list"]])
    return dict(root=root, cols=cols, kg=kg, jkg=jkg, vocab=vocab, jds=jds, ds=ds,
                ds_np=ds_np, sizes=sizes)


def _rows(data, lo, hi, n=12):
    """n codes whose largest graph has lo < nodes <= hi (one of them the
    largest such)."""
    s = data["sizes"]
    pick = np.flatnonzero((s > lo) & (s <= hi))
    assert len(pick) > 0, (lo, hi)
    small = np.flatnonzero(s <= lo)
    return ([int(pick[np.argmax(s[pick])])] + [int(i) for i in pick[:n // 2]]
            + [int(i) for i in small[:n]])[:n]


def _assert_code_batches_equal(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


def _numpy(x):
    """A compact field as numpy: int16 tensors hold uint16 bytes."""
    if x is None:
        return None
    a = x.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


@pytest.mark.parametrize("ln_range", [(0, 8), (8, 16), (16, 128), (128, 512)])
@pytest.mark.parametrize("aug_seed", [None, 3])
def test_unpacked_compact_equals_make_batch_on_each_route(data, ln_range, aug_seed):
    idx = _rows(data, *ln_range)
    for ds in (data["ds"], data["ds_np"]):
        cb, fence = ds.make_batch_compact(idx, aug_seed=aug_seed)
        fence.set_fence("cpu")
        _assert_code_batches_equal(unpack_compact(cb), ds.make_batch(idx, aug_seed=aug_seed))
        if ds.native is None:
            assert cb.edge_packed.dtype == torch.int32 and cb.outdeg is None


ENCODINGS = {"uint16": (8, 16), "stream": (128, 512), "int32": (128, 512)}


@pytest.mark.parametrize("encoding", list(ENCODINGS))
@pytest.mark.parametrize("aug_seed", [None, 0, 12345])
@pytest.mark.parametrize("forced", [False, True])
def test_compact_batch_matches_jax(data, monkeypatch, encoding, aug_seed, forced):
    ds, jds = data["ds"], data["jds"]
    if encoding == "int32":
        # int32 pairs serve Ln > 256 below the stream threshold
        monkeypatch.setattr(dataset_module, "STREAM_MIN_NODES", 1 << 30)
        monkeypatch.setattr(jax_dataset_module, "STREAM_MIN_NODES", 1 << 30)
    idx = _rows(data, *ENCODINGS[encoding])
    shapes = None
    if forced:
        Lt, Ln, Epg = ds.batch_shapes(idx)
        shapes = (Lt, Ln, max(Epg // 4, 4))    # cuts the largest graphs
    got, _ = ds.make_batch_compact(idx, aug_seed=aug_seed, force_shapes=shapes)
    want, _ = jds.make_batch_compact(idx, aug_seed=aug_seed, force_shapes=shapes)
    for name in want._fields:
        w = getattr(want, name)
        g = _numpy(getattr(got, name))
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
            assert g.dtype == np.asarray(w).dtype, name
    assert {"uint16": np.uint16, "stream": np.uint16, "int32": np.int32}[encoding] == \
        _numpy(got.edge_packed).dtype
    assert (got.outdeg is not None) == (encoding == "stream")
    _assert_code_batches_equal(unpack_compact(got), jax_unpack_compact(want))
    if forced:
        assert int(got.ne.max()) == shapes[2]


def test_edge_bucket_grows_like_jax(data):
    """Codes of the 8-node bucket start at 4 edge slots and grow to 16."""
    ds, jds = data["ds"], data["jds"]
    idx = _rows(data, 0, 8)
    Lt, Ln, Epg = ds.batch_shapes(idx)
    assert (Ln, Epg) == (8, 4)
    got, _ = ds.make_batch_compact(idx, aug_seed=7)
    want, _ = jds.make_batch_compact(idx, aug_seed=7)
    assert got.edge_packed.shape[0] // len(idx) > Epg
    assert got.edge_packed.shape == np.asarray(want.edge_packed).shape
    _assert_code_batches_equal(unpack_compact(got), jax_unpack_compact(want))
    _assert_code_batches_equal(ds.make_batch(idx, aug_seed=7), jds.make_batch(idx, aug_seed=7))


def test_numpy_route_compresses_the_classic_batch_as_jax(data):
    ds_np = data["ds_np"]
    cols = data["cols"]
    jnp_ds = JaxDataset(data["jkg"], data["root"] / "codes.parquet", JaxWordPiece(data["vocab"]),
                        cfg=JaxDataConfig(**DATA))
    jnp_ds.native = None
    for idx in (_rows(data, 0, 8), _rows(data, 128, 512)):
        for aug_seed in (None, 5):
            got, _ = ds_np.make_batch_compact(idx, aug_seed=aug_seed, want_text=False)
            want, _ = jnp_ds.make_batch_compact(idx, aug_seed=aug_seed, want_text=False)
            for name in want._fields:
                w, g = getattr(want, name), _numpy(getattr(got, name))
                assert (w is None) == (g is None), name
                if w is not None:
                    np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
            assert got.input_ids.shape == (len(idx), 0)
    assert len(cols["pkg_index_list"]) == N_CODES


def test_warm_cache_arena_and_host_counts_match_jax(data):
    # fresh datasets: the text store's layout follows the order of encoding
    ds = MedCodeDataset.from_columns(data["kg"], data["cols"], WordPieceTokenizer(data["vocab"]),
                                     cfg=DataConfig(**DATA))
    jds = JaxDataset(data["jkg"], data["root"] / "codes.parquet", JaxWordPiece(data["vocab"]),
                     cfg=JaxDataConfig(**DATA))
    ds.warm_cache(tokenize=True)
    jds.warm_cache(tokenize=True)
    np.testing.assert_array_equal(ds._node_arena, jds._node_arena)
    np.testing.assert_array_equal(ds._node_arena_off, jds._node_arena_off)
    assert ds._node_arena.dtype == np.int32
    np.testing.assert_array_equal(ds.node_list(5), [7, 12, 12, 400, 900])
    assert len(ds.node_list(6)) == 0
    np.testing.assert_array_equal(ds.node_counts(0, N_CODES), jds.node_counts(0, N_CODES))
    for ln in (8, 128):
        np.testing.assert_array_equal(ds.edge_counts(3, 90, ln=ln), jds.edge_counts(3, 90, ln=ln))
    assert data["ds_np"].edge_counts(0, 4, ln=8) is None
    t, jt = ds._text, jds._text
    np.testing.assert_array_equal(t.start, jt.start)
    np.testing.assert_array_equal(t.length, jt.length)
    np.testing.assert_array_equal(t.arena[:t.tail], jt.arena[:jt.tail])
    for idx in ([0, 5, 6, 7], list(range(40, 80))):
        assert ds.batch_shapes(idx) == jds.batch_shapes(idx)
    # after warm_cache the arena-indexed packers serve the batches
    _assert_code_batches_equal(unpack_compact(ds.make_batch_compact(list(range(40)))[0]),
                               jax_unpack_compact(jds.make_batch_compact(list(range(40)))[0]))


def test_text_cache_round_trip_and_narrowing_guard(data, tmp_path, monkeypatch):
    cols, kg, vocab = data["cols"], data["kg"], data["vocab"]
    ds = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                     cfg=DataConfig(**DATA), cache_dir=tmp_path)
    ds.warm_cache(tokenize=True)
    ds.save_text_cache()
    cache = tmp_path / "med_code_descriptions.npz"
    assert cache.exists()
    again = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                        cfg=DataConfig(**DATA), cache_dir=tmp_path)
    monkeypatch.setattr(again._encoder, "encode_batch_flat", None)   # nothing re-encodes
    for i in range(N_CODES):
        np.testing.assert_array_equal(again.text_ids(i), ds.text_ids(i))
    assert again._text.arena.dtype == np.int16
    # the JAX package reads the port's cache file alike
    jds = JaxDataset(data["jkg"], data["root"] / "codes.parquet", JaxWordPiece(vocab),
                     cfg=JaxDataConfig(**DATA), cache_dir=tmp_path)
    np.testing.assert_array_equal(jds._text.start, again._text.start)
    # a cache written under a larger vocabulary (an id above int16) is not
    # narrowed into the int16 store: it is ignored, as in the JAX package
    z = dict(np.load(cache))
    z["arena"] = z["arena"].astype(np.int32)
    z["arena"][0] = 40_000
    np.savez(cache, **z)
    for d in (MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                          cfg=DataConfig(**DATA), cache_dir=tmp_path),
              JaxDataset(data["jkg"], data["root"] / "codes.parquet", JaxWordPiece(vocab),
                         cfg=JaxDataConfig(**DATA), cache_dir=tmp_path)):
        assert (d._text.start == -1).all() and d._text.tail == 0
    # and one of another row count too
    np.savez(cache, start=z["start"][:3], length=z["length"][:3], arena=z["arena"][:5] * 0)
    fresh = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                        cfg=DataConfig(**DATA), cache_dir=tmp_path)
    assert (fresh._text.start == -1).all()
    # no cache_dir: save does nothing
    data["ds_np"].save_text_cache()
