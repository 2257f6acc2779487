"""A workdir of the JAX trainer as the port's export input.

A tiny JAX workdir is written in this process: args.json and one orbax step
saved through ``medtok_tpu.utils.checkpoint.CheckpointManager`` (the state
``create_train_state`` builds, with a nonzero usage FIFO and counts).

- ``scripts/jax_workdir_to_npz.py`` turns it into a ``/``-keyed .npz whose
  keys, dtypes and values are those ``convert.save_npz`` writes for the
  same params and usage;
- the port's ``cli.export --config <workdir>/args.json --params <npz>
  --device cpu`` exports it (both routes), equal to the JAX export of the
  same state under ``compare_exports`` and the tie-gap rule, with the usage
  buffers loaded;
- the port's ``--workdir`` on the JAX workdir stops with a message that
  names the script and the ``--config/--params`` form.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.config import MedTokConfig as JaxMedTokConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import export_all as jax_export_all
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.train.trainer import TrainState, make_optimizer
from medtok_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import write_jsonl
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from tests.test_model import tiny_config
from tests.test_torch_dp_export import write_kg_csv
from tests.test_torch_export import DATA, KG_NODES, N_CODES, _synthetic, _vocab
from tests.test_torch_export_routes import _assert_tokens_agree

REPO = Path(__file__).resolve().parent.parent
STEP = 3
BATCH = 8
NAMES = ("embeddings_all", "tokens_all", "weights_all")


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_workdir_to_npz", REPO / "scripts" / "jax_workdir_to_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_workdir(tmp_path_factory):
    """The data files, the JAX workdir, the converted .npz and the JAX
    export of the saved state (unpacked, batches of 8)."""
    root = tmp_path_factory.mktemp("jax_workdir")
    rng = np.random.default_rng(0)
    df = synthetic_vocab_frame(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                               max_pkg_nodes=DENSE_ADJ_MIN_NODES)
    jkg = jax_synthetic_kg(rng, num_nodes=KG_NODES, num_edges=30_000, local_frac=0.7)
    df.to_parquet(root / "codes.parquet")
    cols, kg = _synthetic()
    write_jsonl(cols, root / "codes.jsonl")
    write_kg_csv(kg, root / "kg.csv")
    vocab = _vocab()
    (root / "vocab.txt").write_text("".join(t + "\n" for t in vocab))

    jcfg = dataclasses.replace(
        tiny_config(), max_text_length=64,
        graph=dataclasses.replace(tiny_config().graph, num_nodes=KG_NODES))
    cfg = JaxMedTokConfig(model=jcfg, data=JaxDataConfig(
        **DATA, kg_path=str(root / "kg.csv"),
        med_codes_pkg_map_path=str(root / "codes.parquet"),
        text_vocab_path=str(root / "vocab.txt")))
    jds = JaxDataset(jkg, root / "codes.parquet", JaxWordPiece(vocab), cfg=cfg.data)
    jmodel = JaxTokenizer(jcfg)
    sample = jax.tree.map(jnp.asarray, jax_collate([jds[0]], jds.cfg))
    variables = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False))(sample)
    q = jcfg.quantizer
    used = rng.integers(0, q.codebook_size, q.usage_buffer_size).astype(np.int32)
    usage = {"quantize": {"codebook_used": jnp.asarray(used),
                          "usage_counts": jnp.asarray(np.bincount(
                              used, minlength=q.codebook_size).astype(np.int32))}}
    params = variables["params"]
    state = TrainState(step=jnp.asarray(STEP, jnp.int32), params=params,
                       opt_state=make_optimizer(cfg).init(params), usage=usage,
                       ema_params=None, rng=jax.random.PRNGKey(2))
    workdir = root / "results" / "run"
    JaxCheckpointManager(workdir, config=cfg).save(state)
    want = jax_export_all(jmodel, params, usage, jds, batch_size=BATCH,
                          out_dir=root / "jax", packed=False)
    _script().main(["--workdir", str(workdir), "--out", str(root / "params.npz")])
    host = jax.tree.map(np.asarray, {"params": params, "usage": usage})
    save_npz(host, root / "reference.npz")
    return dict(root=root, workdir=workdir, want=want, usage=host["usage"])


def test_npz_layout_is_save_npz(jax_workdir):
    root = jax_workdir["root"]
    with np.load(root / "params.npz") as got, np.load(root / "reference.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert any(k.startswith("usage/") for k in got.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_script_restores_the_step_asked_for(jax_workdir, tmp_path):
    script = _script()
    assert script.convert(jax_workdir["workdir"], tmp_path / "p.npz", STEP) == (
        STEP, len(np.load(jax_workdir["root"] / "params.npz").files))
    with pytest.raises(FileNotFoundError, match="saved steps"):
        script.convert(jax_workdir["workdir"], tmp_path / "q.npz", STEP + 1)


def _cli_argv(jax_workdir, out: Path, route: str) -> list[str]:
    root, workdir = jax_workdir["root"], jax_workdir["workdir"]
    return ["--config", str(workdir / "args.json"), "--params", str(root / "params.npz"),
            "--kg", str(root / "kg.csv"), "--codes", str(root / "codes.jsonl"),
            "--vocab", str(root / "vocab.txt"), "--device", "cpu", "--packed", route,
            "--batch-size", str(BATCH), "--out-dir", str(out)]


@pytest.mark.parametrize("route", ["off", "on"])
def test_port_exports_the_jax_workdir(jax_workdir, route, tmp_path):
    got = export_cli.main(_cli_argv(jax_workdir, tmp_path, route))
    report = compare_exports(jax_workdir["root"] / "jax", tmp_path)
    assert report["num_codes"] == N_CODES
    _assert_tokens_agree(got, jax_workdir["want"])
    differ = int((got["tokens_all"] != jax_workdir["want"]["tokens_all"]).any(axis=(1, 2))
                 .sum())
    assert report["embeddings_all"]["rows_outside_tol"] <= differ


def test_usage_buffers_are_loaded(jax_workdir):
    cfg = MedTokConfig.load(jax_workdir["workdir"] / "args.json")
    model = load_params(MultimodalTokenizer(cfg.model), jax_workdir["root"] / "params.npz")
    for name, want in jax_workdir["usage"]["quantize"].items():
        assert want.any()
        np.testing.assert_array_equal(model.get_buffer(f"quantize.{name}").numpy(), want)


def test_port_workdir_on_a_jax_workdir_names_the_script(jax_workdir, tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        export_cli.main(["--workdir", str(jax_workdir["workdir"]), "--device", "cpu",
                         "--out-dir", str(tmp_path)])
    msg = str(e.value)
    assert "orbax step directories (0000003)" in msg
    assert "scripts/jax_workdir_to_npz.py" in msg and "--config" in msg and "--params" in msg
    assert not any(tmp_path.iterdir())
