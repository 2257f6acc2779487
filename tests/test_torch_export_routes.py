"""The export's other routes against the JAX package at fp32 on the CPU: the
unpacked ``export_all(packed=False)`` (batches of codes through the dense
BERT, the tail batch padded with repeats), the export CLI's ``--packed off
--batch-size``, and the artifact-only ``PretrainedMedTok`` on the files."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import tie_gaps
from medtok_tpu.api import PretrainedMedTok as JaxPretrained
from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import export_all as jax_export_all
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu_torch.api import PretrainedMedTok
from medtok_tpu_torch.config import DataConfig, MedTokConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import MedCodeDataset, write_jsonl
from medtok_tpu_torch.data.text import WordPieceTokenizer
from medtok_tpu_torch.export import export_all, export_all_packed
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from tests.test_model import tiny_config
from tests.test_torch_export import DATA, KG_NODES, N_CODES, _synthetic, _vocab

BATCH = 8   # N_CODES = 48 is no multiple of 5 or 7: a padded tail batch


def _assert_tokens_agree(got: dict, want: dict) -> None:
    """Token rows equal but for fp32 ties (the reference's gap < 1e-5,
    docs/PARITY.md); embeddings within 1e-5 on the rows that agree."""
    gaps = tie_gaps(got["tokens_all"], got["weights_all"], want["tokens_all"],
                    want["weights_all"])
    assert gaps.max(initial=0.0) <= 1e-5, gaps
    same = (got["tokens_all"] == want["tokens_all"]).all(axis=(1, 2))
    np.testing.assert_allclose(got["embeddings_all"][same], want["embeddings_all"][same],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["weights_all"][same], want["weights_all"][same],
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("routes")
    rng = np.random.default_rng(0)
    df = synthetic_vocab_frame(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                               max_pkg_nodes=DENSE_ADJ_MIN_NODES)
    jkg = jax_synthetic_kg(rng, num_nodes=KG_NODES, num_edges=30_000, local_frac=0.7)
    df.to_parquet(root / "codes.parquet")
    cols, kg = _synthetic()
    write_jsonl(cols, root / "codes.jsonl")
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
    want = jax_export_all(jmodel, variables["params"], variables["usage"], jds,
                          batch_size=BATCH, out_dir=root / "jax", packed=False)
    cfg = MedTokConfig.from_dict(
        {"model": dataclasses.asdict(jcfg), "data": dataclasses.asdict(jds.cfg)})
    save_npz(jax.tree.map(np.asarray, variables["params"]), root / "params.npz")
    model = load_params(MultimodalTokenizer(cfg.model), root / "params.npz")
    got = export_all(model, ds, batch_size=BATCH, device="cpu", out_dir=root / "torch")
    return dict(root=root, cfg=cfg, model=model, ds=ds, kg=kg, want=want, got=got)


def test_unpacked_export_matches_jax(exports):
    report = compare_exports(exports["root"] / "jax", exports["root"] / "torch")
    assert report["num_codes"] == N_CODES
    _assert_tokens_agree(exports["got"], exports["want"])
    assert exports["got"]["embeddings_all"].shape == (N_CODES, 64)


def test_unpacked_export_agrees_with_the_packed_one(exports):
    packed = export_all(exports["model"], exports["ds"], packed=True, device="cpu")
    direct = export_all_packed(exports["model"], exports["ds"], device="cpu")
    for name in packed:
        np.testing.assert_array_equal(packed[name], direct[name])
    _assert_tokens_agree(exports["got"], packed)


@pytest.mark.parametrize("batch_size", [BATCH, N_CODES + 5])
def test_unpacked_export_does_not_depend_on_the_batch(exports, batch_size):
    """A different batch size (one batch larger than the vocabulary: all
    tail) writes the same rows."""
    got = export_all(exports["model"], exports["ds"], batch_size=batch_size, device="cpu")
    _assert_tokens_agree(got, exports["got"])


def test_export_cli_packed_off(exports, tmp_path):
    from medtok_tpu_torch.cli import export as cli

    kg, root = exports["kg"], exports["root"]
    names = [f"rel_{r}" for r in kg.rel_index]
    with open(tmp_path / "kg.csv", "w") as f:
        f.write("x_index,y_index,display_relation\n")
        f.writelines(map("{},{},{}\n".format, kg.edge_src.tolist(), kg.edge_dst.tolist(),
                         names))
    (tmp_path / "vocab.txt").write_text("".join(t + "\n" for t in _vocab()))
    exports["cfg"].save(tmp_path / "args.json")
    common = ["--config", str(tmp_path / "args.json"), "--params", str(root / "params.npz"),
              "--kg", str(tmp_path / "kg.csv"), "--codes", str(root / "codes.jsonl"),
              "--vocab", str(tmp_path / "vocab.txt"), "--device", "cpu"]
    arrays = cli.main([*common, "--packed", "off", "--batch-size", "8",
                       "--out-dir", str(tmp_path / "off")])
    for name, arr in arrays.items():
        np.testing.assert_array_equal(arr, exports["got"][name])
        np.testing.assert_array_equal(np.load(tmp_path / "off" / f"{name}.npy"), arr)
    packed = cli.main([*common, "--out-dir", str(tmp_path / "on")])
    _assert_tokens_agree(arrays, packed)


def test_pretrained_medtok_matches_jax(exports):
    root = exports["root"]
    jax_api = JaxPretrained(root / "jax", root / "codes.parquet")
    for vocab in ("codes.jsonl", "codes.parquet"):
        api = PretrainedMedTok(root / "jax", root / vocab)
        for i in (0, 17, N_CODES - 1):
            code = exports["ds"].code_at(i)
            assert api.lookup(code) == jax_api.lookup(code) == i
            np.testing.assert_array_equal(api.embed(code), jax_api.embed(code))
            np.testing.assert_array_equal(api.tokenize(code), jax_api.tokenize(code))
            np.testing.assert_array_equal(api.encode(code), jax_api.encode(code))
        with pytest.raises(KeyError):
            api.lookup("NOPE")
        with pytest.raises(KeyError):
            jax_api.lookup("NOPE")


def test_pretrained_medtok_first_occurrence(tmp_path):
    """A code listed twice maps to its first row, as in the JAX API."""
    import pandas as pd

    cols = {"med_code": ["A", "B", "A"], "desc": ["x", "y", "z"],
            "pkg_index_list": [[1], [2], [3]]}
    write_jsonl(cols, tmp_path / "codes.jsonl")
    pd.DataFrame(cols).to_parquet(tmp_path / "codes.parquet")
    emb = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "embeddings_all.npy", emb)
    api = PretrainedMedTok(tmp_path, tmp_path / "codes.jsonl")
    jax_api = JaxPretrained(tmp_path, tmp_path / "codes.parquet")
    assert api.lookup("A") == jax_api.lookup("A") == 0
    np.testing.assert_array_equal(api.embed("B"), jax_api.embed("B"))
    assert api.tokens is None and jax_api.tokens is None
