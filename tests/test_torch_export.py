"""The slice as a whole: the port's packed full-vocabulary export against the
JAX package's ``_export_all_packed`` on the same synthetic vocabulary and
weights at fp32, plus the host pieces it is built from (synthetic data,
WordPiece, packing, collate, config, weight files) and the API."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.config import MedTokConfig as JaxMedTokConfig
from medtok_tpu.data.compact import derive_packed_meta as jax_derive_packed_meta
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.packing import pack_store_meta as jax_pack_store_meta
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import _export_all_packed
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu_torch.api import MedTok
from medtok_tpu_torch.config import DataConfig, MedTokConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import MedCodeDataset
from medtok_tpu_torch.data.packing import derive_packed_meta
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.export import export_all_packed, export_groups
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from tests.test_model import tiny_config

N_CODES, KG_NODES = 48, 3000
DATA = dict(text_buckets=(8, 16, 32, 64), node_buckets=(8, DENSE_ADJ_MIN_NODES),
            edge_buckets=(16, 256), max_text_length=64)
# small packed steps (2 rows of 64 tokens), so the sweep takes several
# groups, some on the scatter GCN path (Ln=8) and some on the dense one
PACK = dict(row_len=64, num_rows=2)


def _vocab():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    return vocab


def _synthetic(rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=DENSE_ADJ_MIN_NODES)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=30_000, local_frac=0.7)
    return cols, kg


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same vocabulary, KG and weights on both sides, and both exports."""
    root = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(0)
    df = synthetic_vocab_frame(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                               max_pkg_nodes=DENSE_ADJ_MIN_NODES)
    jkg = jax_synthetic_kg(rng, num_nodes=KG_NODES, num_edges=30_000, local_frac=0.7)
    df.to_parquet(root / "codes.parquet")
    cols, kg = _synthetic()
    vocab = _vocab()
    jds = JaxDataset(jkg, root / "codes.parquet", JaxWordPiece(vocab),
                     cfg=JaxDataConfig(**DATA))
    ds = MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab),
                                     cfg=DataConfig(**DATA))

    jcfg = dataclasses.replace(
        tiny_config(), max_text_length=64,
        graph=dataclasses.replace(tiny_config().graph, num_nodes=KG_NODES))
    jmodel = JaxTokenizer(jcfg)
    sample = jax.tree.map(jnp.asarray, jax_collate([jds[0]], jds.cfg))
    variables = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False))(sample)
    _export_all_packed(jmodel, variables["params"], variables["usage"], jds,
                       out_dir=root / "jax", **PACK)

    cfg = MedTokConfig.from_dict(
        {"model": dataclasses.asdict(jcfg), "data": dataclasses.asdict(jds.cfg)})
    save_npz(jax.tree.map(np.asarray, variables["params"]), root / "params.npz")
    model = load_params(MultimodalTokenizer(cfg.model), root / "params.npz")
    arrays = export_all_packed(model, ds, device="cpu", out_dir=root / "torch", **PACK)
    return dict(root=root, jds=jds, ds=ds, df=df, jkg=jkg, cols=cols, kg=kg,
                cfg=cfg, model=model, arrays=arrays)


def test_packed_export_matches_jax(both):
    report = compare_exports(both["root"] / "jax", both["root"] / "torch")
    assert report["num_codes"] == N_CODES
    # identical tokens: stricter than the boundary-tie rule (gap < 1e-5)
    assert report["token_exact_match"], report["token_id_parity"]
    assert report["embeddings_all"]["max_abs_err"] <= 1e-5, report
    assert report["weights_all"]["max_abs_err"] <= 1e-5, report
    # the sweep took several groups over both GCN aggregation paths
    groups = export_groups(both["ds"], **PACK)
    lns = {both["ds"].make_batch(g.tolist()).node_ids.shape[1] for g in groups}
    assert len(groups) > 2 and lns == {8, DENSE_ADJ_MIN_NODES}


def test_api_serves_exported_rows(both, tmp_path):
    both["cfg"].save(tmp_path / "args.json")
    api = MedTok.from_npz(tmp_path / "args.json", both["root"] / "params.npz",
                          both["ds"], device="cpu")
    for i in (0, 17, N_CODES - 1):
        code = both["ds"].code_at(i)
        np.testing.assert_array_equal(api.tokenize(code), both["arrays"]["tokens_all"][i])
        assert api.encode(code).shape == (20,)
        np.testing.assert_allclose(api.embed(code), both["arrays"]["embeddings_all"][i],
                                   atol=1e-4, rtol=0)
    batch = api.tokenize_batch([both["ds"].code_at(i) for i in (3, 4)])
    np.testing.assert_array_equal(batch.tokens, both["arrays"]["tokens_all"][[3, 4]])
    with pytest.raises(KeyError):
        api.tokenize("NOPE")


def test_cli_export_from_files(both, tmp_path):
    """The CLI reads args.json, the params .npz, kg.csv, the codes parquet and
    vocab.txt, and writes the same artifacts as the in-memory export."""
    import pandas as pd

    from medtok_tpu_torch.cli import export as cli

    kg, root = both["kg"], both["root"]
    pd.DataFrame({"x_index": kg.edge_src, "y_index": kg.edge_dst,
                  "display_relation": [f"rel_{r}" for r in kg.rel_index]}
                 ).to_csv(tmp_path / "kg.csv", index=False)
    (tmp_path / "vocab.txt").write_text("".join(t + "\n" for t in _vocab()))
    both["cfg"].save(tmp_path / "args.json")
    cli.main(["--config", str(tmp_path / "args.json"),
              "--params", str(root / "params.npz"), "--kg", str(tmp_path),
              "--codes", str(root / "codes.parquet"),
              "--vocab", str(tmp_path / "vocab.txt"), "--device", "cpu",
              "--out-dir", str(tmp_path / "out")])
    report = compare_exports(root / "torch", tmp_path / "out")
    assert report["token_exact_match"], report["token_id_parity"]
    assert report["embeddings_all"]["max_abs_err"] <= 1e-5, report


def test_synthetic_data_matches_jax(both):
    df, cols = both["df"], both["cols"]
    assert cols["med_code"] == df["med_code"].tolist()
    assert cols["desc"] == df["desc"].tolist()
    for a, b in zip(cols["pkg_index_list"], df["pkg_index_list"]):
        np.testing.assert_array_equal(a, b)
    for f in ("edge_src", "edge_dst", "rel_index"):
        np.testing.assert_array_equal(getattr(both["kg"], f), getattr(both["jkg"], f))


def test_host_batches_match_jax(both):
    """WordPiece ids, the packed rows and their derived metadata, and the
    collated graph batch are the JAX package's, array for array."""
    ds, jds = both["ds"], both["jds"]
    ds.warm_cache()
    for i in range(N_CODES):
        np.testing.assert_array_equal(ds.text_ids(i), jds.text_ids(i))
    rows = np.arange(5, 30)
    t = ds._text
    got = ds.pack_text_rows(rows, row_len=64, num_rows=16)
    want = jax_pack_store_meta(t.arena, t.start, t.length, rows, row_len=64, num_rows=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    meta = derive_packed_meta(torch.from_numpy(got[1]), torch.from_numpy(got[2]),
                              num_rows=16, row_len=64, lmax=64)
    jmeta = jax_derive_packed_meta(jnp.asarray(got[1]), jnp.asarray(got[2]),
                                   num_rows=16, row_len=64, lmax=64)
    for g, w in zip(meta, jmeta):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx = [0, 3, 11, 20, 47]
    got_b = ds.make_batch(idx)
    want_b = jax_collate([jds[i] for i in idx], jds.cfg, pad_id=jds.tokenizer.pad_id)
    for name, g, w in zip(got_b._fields, got_b, want_b):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_tie_gaps_of_differing_token_rows():
    """chip_smoke.py's tie-gap reading, on rows with known distances: an
    order swap, a boundary swap and a pick far outside the top k."""
    from chip_smoke import K, tie_gaps

    d = np.linspace(0.1, 2.0, 30)                    # distances, ascending
    d[2], d[K] = d[1] + 2e-7, d[K - 1] + 3e-7        # an inner and a boundary tie

    def row(picks):
        v = d[list(picks)]
        return np.asarray(picks, np.int32), (np.exp(-v) / np.exp(-v).sum()).astype(np.float32)

    ref_t, ref_w = row(range(K))
    cases = [(range(K), 0.0),                        # identical: no gap listed
             ((0, 2, 1, 3, 4), 2e-7),                # order swap
             ((0, 1, 2, 3, K), 3e-7),                # boundary swap
             ((0, 1, 2, 3, 20), d[20] - d[K - 1])]   # a real disagreement
    for picks, want in cases:
        t, w = row(picks)
        gaps = tie_gaps(t[None], w[None], ref_t[None], ref_w[None])
        if want == 0.0:
            assert gaps.size == 0
        else:
            # fp32 weights carry the distances to about 1e-7
            np.testing.assert_allclose(gaps, [want], atol=1e-7, rtol=0)
    t, w = row(range(10, 10 + K))                    # nothing in common
    assert np.isinf(tie_gaps(t[None], w[None], ref_t[None], ref_w[None])).all()


def test_config_loads_jax_args_json(tmp_path):
    jcfg = JaxMedTokConfig()
    jcfg.save(tmp_path / "args.json")
    cfg = MedTokConfig.load(tmp_path / "args.json")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.model.embedding_dim == 256 and cfg.model.split == (64, 64)
