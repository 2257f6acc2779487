"""The packed export on the native compact route: the port's
``export_all_packed`` (C++ WordPiece and packer, compact batches in pooled
buffers, int16 text rows, ``unpack_compact`` on the device) against the JAX
package's ``_export_all_packed`` on its default (native) route, at the
verify recipe's widths in fp32 (text 32 / 4 heads, codebook 90 x 16), by
``compare_exports``; and against the port's own export on the numpy route
(``native=False``). The vocabulary's node buckets take both compact
encodings: uint16 pairs (8, 64) and the stream (128)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.kg import KnowledgeGraph as JaxKG
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import _export_all_packed
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu_torch.config import DataConfig, MedTokConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import STREAM_MIN_NODES, MedCodeDataset
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.export import export_all_packed, export_groups
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.utils.profiling import counters
from tests.test_model import tiny_config

N_CODES, KG_NODES = 64, 3000
DATA = dict(text_buckets=(8, 16, 32, 64), node_buckets=(8, 64, 128),
            edge_buckets=(16, 256, 1024), max_text_length=64)
PACK = dict(row_len=64, num_rows=2)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_native")
    rng = np.random.default_rng(2)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=16, heavy_tail=True)
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
    datasets = {}
    for name, is_native in (("native", True), ("numpy", False)):
        ds = datasets[name] = MedCodeDataset.from_columns(
            kg, cols, WordPieceTokenizer(vocab), cfg=DataConfig(**DATA), native=is_native)
        export_all_packed(model, ds, device="cpu", out_dir=root / name, **PACK)
    return dict(root=root, datasets=datasets, model=model)


def test_native_export_matches_jax(exports):
    report = compare_exports(exports["root"] / "jax", exports["root"] / "native")
    assert report["num_codes"] == N_CODES
    assert report["token_exact_match"], report["token_id_parity"]
    assert report["embeddings_all"]["max_abs_err"] <= 1e-5, report
    assert report["weights_all"]["max_abs_err"] <= 1e-5, report


def test_native_export_matches_the_numpy_route(exports):
    report = compare_exports(exports["root"] / "numpy", exports["root"] / "native")
    assert report["token_exact_match"], report["token_id_parity"]
    assert report["embeddings_all"]["max_abs_err"] <= 1e-5, report


def test_export_took_both_compact_encodings_from_the_pool(exports):
    ds = exports["datasets"]["native"]
    groups = export_groups(ds, **PACK)
    lns = {ds.batch_shapes(g.tolist())[1] for g in groups}
    assert {8, 64} & lns and max(lns) >= STREAM_MIN_NODES
    keys = set(ds.native._pools)
    assert any(k[4] == "stream" for k in keys) and any(k[4] is True for k in keys)
    # pageable pools for a CPU export, and nothing left waiting on a fence
    assert ds.native.pool_bytes(pinned=True) == 0
    assert all(e.fence is None for pool in ds.native._pools.values() for e in pool)
    assert exports["datasets"]["numpy"].native is None
    assert counters()["native.pack_s"] > 0
