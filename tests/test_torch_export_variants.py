"""The export of a tiny GAT + kmeans (+ revival) model against the JAX
export of the same parameters and usage collection, fp32 on the CPU: the
port's unpacked and packed sweeps against JAX's unpacked sweep under
``medtok_tpu/export/parity.py::compare_exports`` and the tie-gap rule
(token rows equal but for fp32 ties, gap below 1e-5; embeddings and
weights within 1e-5 on the rows that agree). The EMA codebook is set to
random unit rows, so the four sweeps read it and not the placeholder."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import export_all as jax_export_all
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu_torch.config import DataConfig, MedTokConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import MedCodeDataset
from medtok_tpu_torch.data.text import WordPieceTokenizer
from medtok_tpu_torch.export import export_all
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from tests.test_model import tiny_config
from tests.test_torch_export import DATA, KG_NODES, N_CODES, _synthetic, _vocab
from tests.test_torch_export_routes import _assert_tokens_agree

BATCH = 8


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants")
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
    base = tiny_config(use_kmeans=True, codebook_revival=True)
    jcfg = dataclasses.replace(
        base, max_text_length=64,
        graph=dataclasses.replace(base.graph, num_nodes=KG_NODES, model_name="GAT"))
    jmodel = JaxTokenizer(jcfg)
    sample = jax.tree.map(jnp.asarray, jax_collate([jds[0]], jds.cfg))
    variables = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False))(sample)
    params = jax.tree.map(np.asarray, variables["params"])
    usage = jax.tree.map(np.asarray, variables["usage"])
    x = np.random.default_rng(3).normal(size=usage["quantize"]["ema_codebook"].shape)
    usage["quantize"]["ema_codebook"] = (
        x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    want = jax_export_all(jmodel, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, usage), jds, batch_size=BATCH,
                          out_dir=root / "jax", packed=False)
    cfg = MedTokConfig.from_dict(
        {"model": dataclasses.asdict(jcfg), "data": dataclasses.asdict(jds.cfg)})
    save_npz({"params": params, "usage": usage}, root / "variables.npz")
    model = load_params(MultimodalTokenizer(cfg.model), root / "variables.npz")
    got = {route: export_all(model, ds, batch_size=BATCH, packed=route == "packed",
                             device="cpu", out_dir=root / route)
           for route in ("unpacked", "packed")}
    return dict(root=root, model=model, want=want, got=got)


@pytest.mark.parametrize("route", ["unpacked", "packed"])
def test_gat_kmeans_export_matches_jax(exports, route):
    root = exports["root"]
    q = exports["model"].quantize
    assert q.cfg.use_kmeans and exports["model"].graph_encoder.model_name == "GAT"
    report = compare_exports(root / "jax", root / route)
    assert report["num_codes"] == N_CODES
    assert report["embeddings_all"]["max_abs_err"] <= 1e-4, report
    _assert_tokens_agree(exports["got"][route], exports["want"])
    assert q._cb() is q.ema_codebook and not hasattr(q, "codebook")
    assert exports["got"][route]["embeddings_all"].shape == (N_CODES, 64)
