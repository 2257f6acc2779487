"""The port's train CLI, the export CLI's --workdir route and the BERT
weight bridge, on the CPU at the verify recipe's widths (text 32 / 4 heads,
codebook 90 x 16, batch 8):

- ``config_from_args`` equals the JAX CLI's for the same argv (the GAT,
  kmeans, revival and text-dropout flags too), and the args.json the port
  writes loads in the JAX package to the same config;
- the flags the port refuses at parse time: code it lacks (--mesh-tp,
  --wandb), a --mesh-dp other than the world size, --multihost without
  a launcher;
- ``cli.train`` at --max-steps 3 --ckpt-every 2 checkpoints and rotates,
  and resumes to step 4 with --workdir;
- a GAT + kmeans + revival run: the k-means init at step 0 only, a
  resumed run continuing bit for bit as one run without a break (the EMA
  codebook and the rest of the state), ``cli.export --workdir`` on both
  routes and ``MedTok.from_checkpoint`` of it; a text-dropout run;
- ``cli.export --workdir`` equals ``--config / --params`` on the same
  weights bit for bit, and ``MedTok.from_checkpoint`` gives the export's
  rows;
- ``convert_hf_bert`` equals the JAX ``convert_hf_bert`` followed by
  ``convert.load_params``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch import nn

from medtok_tpu.cli import train as jax_train_cli
from medtok_tpu.config import MedTokConfig as JaxMedTokConfig
from medtok_tpu.config import TextEncoderConfig as JaxTextConfig
from medtok_tpu.models.bert import convert_hf_bert as jax_convert_hf_bert
from medtok_tpu_torch.api import MedTok
from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.cli import train as train_cli
from medtok_tpu_torch.config import TextEncoderConfig
from medtok_tpu_torch.convert import load_params, save_npz
from medtok_tpu_torch.data.dataset import MedCodeDataset, write_jsonl
from medtok_tpu_torch.data.kg import KnowledgeGraph
from medtok_tpu_torch.data.synthetic import MEDICAL_WORDS, SYLLABLES, synthetic_vocab_columns
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.models.bert import BertEncoder, convert_hf_bert
from medtok_tpu_torch.train.trainer import Trainer
from medtok_tpu_torch.utils.checkpoint import CheckpointManager

KG_NODES, N_CODES = 300, 20
# the verify recipe's model flags (a text vocabulary of 256 holds the test vocab)
TINY = ["--global-batch-size", "8", "--codebook-size", "90", "--codebook-embed-dim", "16",
        "--graph-in-channels", "8", "--graph-hidden-channels", "16",
        "--graph-out-channels", "16", "--text-layers", "2", "--text-hidden", "32",
        "--text-heads", "4", "--text-intermediate", "64", "--text-vocab-size", "256",
        "--kg-num-nodes", str(KG_NODES), "--mesh-dp", "1", "--mixed-precision", "none"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """kg.csv, codes.jsonl and vocab.txt of a small synthetic vocabulary."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    cols = synthetic_vocab_columns(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=10)
    src, dst = rng.integers(0, KG_NODES, (2, 3000))
    rels = np.array(["ppi", "target", "indication"])[rng.integers(0, 3, 3000)]
    lines = ["x_index,y_index,display_relation,x_name"] + [
        f"{s},{d},{r},\"n{s}, x\"" for s, d, r in zip(src, dst, rels)]
    (root / "kg.csv").write_text("\n".join(lines) + "\n")
    write_jsonl(cols, root / "codes.jsonl")
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    assert len(vocab) <= 256
    (root / "vocab.txt").write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    return dict(kg=str(root / "kg.csv"), codes=str(root / "codes.jsonl"),
                vocab=str(root / "vocab.txt"))


def _data_flags(files):
    return ["--kg-path", files["kg"], "--med-codes-pkg-map-path", files["codes"],
            "--text-vocab", files["vocab"]]


# ---------------------------------------------------------------- config --

ARGVS = {
    "defaults": ["--text-vocab", "v.txt"],
    "verify-recipe": ["--text-vocab", "v.txt", "--kg-path", "kg/", "--epochs", "1",
                      "--max-steps", "3", "--ckpt-every", "3", *TINY],
    "training-knobs": ["--text-vocab", "v.txt", "--lr", "3e-3", "--ema", "--packed-text",
                       "off", "--beta2", "0.99", "--max-checkpoints", "5",
                       "--edge-dropout-p", "0.25", "--shared-loss-beta", "0.3",
                       "--entropy-loss-ratio", "0.01", "--global-seed", "7"],
    "kmeans": ["--text-vocab", "v.txt", "--kmeans"],
    "text-dropout": ["--text-vocab", "v.txt", "--text-dropout-in-train"],
    "gat": ["--text-vocab", "v.txt", "--graph-model-name", "GAT"],
    "gat-kmeans-revival": ["--text-vocab", "v.txt", "--graph-model-name", "GAT", "--kmeans",
                           "--codebook-revival", *TINY],
    "text-dropout-packed-off": ["--text-vocab", "v.txt", "--text-dropout-in-train",
                                "--packed-text", "off"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_config_from_args_matches_jax(name, tmp_path):
    argv = ARGVS[name]
    cfg = train_cli.config_from_args(train_cli.parse_args(argv))
    want = jax_train_cli.config_from_args(jax_train_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    cfg.save(tmp_path / "args.json")
    assert JaxMedTokConfig.from_dict(json.loads((tmp_path / "args.json").read_text())) == want


REFUSED = {
    "revival-without-kmeans": (["--codebook-revival"], "requires --kmeans"),
    # a mesh without a process group of its size names the launch it needs
    "mesh-dp": (["--mesh-dp", "2"], "torchrun --nproc-per-node 2"),
    "mesh-tp": (["--mesh-tp", "2"], "torchrun --nproc-per-node 2"),
    "wandb": (["--wandb"], "--wandb"),
    "multihost": (["--multihost"], "--multihost"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_the_port_lacks_are_refused_at_parse_time(name, capsys):
    extra, what = REFUSED[name]
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--text-vocab", "v.txt", *extra])
    assert e.value.code == 2 and what in capsys.readouterr().err


def test_packed_text_on_with_text_dropout_is_refused_as_in_jax():
    argv = ["--text-vocab", "v.txt", "--text-dropout-in-train", "--packed-text", "on"]
    for cli in (train_cli, jax_train_cli):
        args = (cli.parse_args(argv) if cli is train_cli
                else cli.build_parser().parse_args(argv))
        with pytest.raises(SystemExit, match="incompatible"):
            cli.config_from_args(args)


# ------------------------------------------------------- train and resume --

@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    """cli.train to step 3 (a checkpoint at 2 and at the end), then resumed
    with --workdir to step 4."""
    results = tmp_path_factory.mktemp("results")
    argv = [*_data_flags(files), "--results-dir", str(results), "--epochs", "3",
            "--max-steps", "3", "--ckpt-every", "2", "--ema", "--device", "cpu", *TINY]
    workdir = train_cli.main(argv)
    first = CheckpointManager(workdir).steps()
    resumed = train_cli.main([*argv[:-len(TINY)], "--workdir", str(workdir),
                              "--max-steps", "4", "--lr", "1.0", *TINY])
    return dict(workdir=workdir, first=first, resumed=resumed)


def test_train_cli_checkpoints_rotates_and_resumes(trained):
    workdir = trained["workdir"]
    assert trained["resumed"] == workdir
    assert trained["first"] == [2, 3]
    mgr = CheckpointManager(workdir)
    assert mgr.steps() == [3, 4]
    # the stored config won over the resumed run's --lr
    assert CheckpointManager.load_config(workdir).train.lr == 1e-4
    log = (workdir / "log.txt").read_text()
    assert "Resumed from the checkpoint at step 3" in log
    steps = [json.loads(line)["step"] for line in open(workdir / "metrics.jsonl")]
    assert steps == [1, 2, 3, 4]
    losses = [json.loads(line)["loss"] for line in open(workdir / "metrics.jsonl")]
    assert all(np.isfinite(losses))
    ck = mgr.load()
    assert ck["step"] == 4 and ck["adam"]["count"] == 4 and ck["ema"] is not None


# ------------------------------------------------------ training variants --

VARIANT = ["--graph-model-name", "GAT", "--kmeans", "--codebook-revival"]


@pytest.fixture(scope="module")
def variant_runs(files, tmp_path_factory):
    """A GAT + kmeans + revival run to step 2 (a checkpoint each step),
    resumed with --workdir to step 3, and the same run to step 3 without a
    break."""
    argv = [*_data_flags(files), "--epochs", "3", "--ckpt-every", "1", "--device", "cpu",
            *VARIANT, *TINY]
    broken = train_cli.main([*argv, "--results-dir", str(tmp_path_factory.mktemp("a")),
                             "--max-steps", "2"])
    at_2 = CheckpointManager(broken).load(2)
    train_cli.main([*argv, "--workdir", str(broken), "--max-steps", "3"])
    straight = train_cli.main([*argv, "--results-dir", str(tmp_path_factory.mktemp("b")),
                               "--max-steps", "3"])
    return dict(broken=broken, straight=straight, at_2=at_2)


def test_variant_resume_is_bitwise(variant_runs):
    broken, straight = (CheckpointManager(variant_runs[k]) for k in ("broken", "straight"))
    cfg = broken.load_config(broken.workdir)
    assert cfg.model.graph.model_name == "GAT" and cfg.model.quantizer.codebook_revival
    log = (broken.workdir / "log.txt").read_text()
    assert log.count("kmeans codebook init done") == 1
    assert "Resumed from the checkpoint at step 2" in log
    a, b = broken.load(3), straight.load(3)
    assert set(a["buffers"]) >= {"quantize.ema_codebook", "quantize.ema_cluster",
                                 "quantize.ema_embed_prob"}
    assert "quantize.codebook" not in a["model"]
    for part in ("model", "buffers"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for x, y in zip(a["adam"]["mu"] + a["adam"]["nu"], b["adam"]["mu"] + b["adam"]["nu"]):
        assert torch.equal(x, y)
    # the EMA codebook moved after the restored step, from the restored value
    at_2 = variant_runs["at_2"]["buffers"]["quantize.ema_codebook"]
    assert not torch.equal(at_2, a["buffers"]["quantize.ema_codebook"])


@pytest.mark.parametrize("packed", ["on", "off"])
def test_variant_workdir_exports(variant_runs, files, tmp_path, packed):
    """cli.export --workdir of the GAT + kmeans run on both routes, and
    MedTok.from_checkpoint of it giving the export's rows."""
    workdir = variant_runs["broken"]
    arrays = export_cli.main(["--workdir", str(workdir), "--device", "cpu", "--packed", packed,
                              "--batch-size", "8", "--out-dir", str(tmp_path)])
    assert arrays["embeddings_all"].shape == (N_CODES, 64)
    assert np.isfinite(arrays["embeddings_all"]).all()
    cfg = CheckpointManager.load_config(workdir)
    dataset = MedCodeDataset.from_path(KnowledgeGraph.from_csv(files["kg"]), files["codes"],
                                       WordPieceTokenizer.from_vocab_file(files["vocab"]),
                                       cfg=cfg.data)
    tok = MedTok.from_checkpoint(workdir, dataset, device="cpu")
    assert torch.equal(tok.model.quantize.ema_codebook,
                       CheckpointManager(workdir).load()["buffers"]["quantize.ema_codebook"])
    out = tok.tokenize_batch(dataset.med_codes[:8])
    assert np.array_equal(out.tokens, arrays["tokens_all"][:8])


def test_text_dropout_run(files, tmp_path):
    """--text-dropout-in-train trains unpacked (packed-text auto goes off)
    to finite losses."""
    workdir = train_cli.main([*_data_flags(files), "--results-dir", str(tmp_path),
                              "--max-steps", "2", "--text-dropout-in-train", "--device", "cpu",
                              *TINY])
    cfg = CheckpointManager.load_config(workdir)
    assert cfg.model.text_dropout_in_train and not cfg.train.packed_text
    losses = [json.loads(line)["loss"] for line in open(workdir / "metrics.jsonl")]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ----------------------------------------------------------------- export --

def _flax_tree(model: nn.Module) -> dict:
    """The port model's parameters as a flax params tree (the inverse of
    convert.py's renames: Dense kernel = weight.T, LayerNorm scale,
    Embed embedding)."""
    tree: dict = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            leaf, value = pname, p.detach().float().numpy()
            if pname == "weight" and isinstance(module, nn.Linear):
                leaf, value = "kernel", value.T
            elif pname == "weight" and isinstance(module, nn.LayerNorm):
                leaf = "scale"
            elif pname == "weight" and isinstance(module, nn.Embedding):
                leaf = "embedding"
            node = tree
            for part in mname.split(".") if mname else []:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(value)
    return tree


def test_export_workdir_equals_config_params(files, tmp_path):
    """The same weights through a training workdir of the port and through
    args.json + a params .npz export bit for bit the same arrays; the
    workdir's MedTok.from_checkpoint gives the export's rows."""
    cfg = train_cli.config_from_args(train_cli.parse_args([*_data_flags(files), *TINY]))
    workdir = tmp_path / "run"
    trainer = Trainer(cfg, device="cpu", workdir=workdir)
    state = trainer.init_state()
    state.step = 9
    trainer.save(state)
    save_npz(_flax_tree(trainer.model), tmp_path / "params.npz")
    back = load_params(Trainer(cfg, device="cpu").model, tmp_path / "params.npz")
    for (k, a), b in zip(trainer.model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k

    a = export_cli.main(["--workdir", str(workdir), "--device", "cpu",
                         "--out-dir", str(tmp_path / "a")])
    b = export_cli.main(["--config", str(workdir / "args.json"), "--params",
                         str(tmp_path / "params.npz"), "--kg", files["kg"], "--codes",
                         files["codes"], "--vocab", files["vocab"], "--device", "cpu",
                         "--out-dir", str(tmp_path / "b")])
    assert a.keys() == b.keys() == {"embeddings_all", "tokens_all", "weights_all"}
    for name in a:
        assert np.array_equal(a[name], b[name]), name
        assert np.array_equal(np.load(tmp_path / "a" / f"{name}.npy"), a[name])
    dataset = MedCodeDataset.from_path(KnowledgeGraph.from_csv(files["kg"]), files["codes"],
                                       WordPieceTokenizer.from_vocab_file(files["vocab"]),
                                       cfg=cfg.data)
    tok = MedTok.from_checkpoint(workdir, dataset, device="cpu")
    out = tok.tokenize_batch(dataset.med_codes[:8])
    assert np.array_equal(out.tokens, a["tokens_all"][:8])
    np.testing.assert_allclose(out.embedding, a["embeddings_all"][:8], rtol=0, atol=1e-6)


def test_export_cli_wants_one_route(files, tmp_path, capsys):
    for argv in ([], ["--config", "a.json"], ["--workdir", str(tmp_path), "--kg", "kg.csv"]):
        with pytest.raises(SystemExit):
            export_cli.main([*argv, "--device", "cpu"])
    assert "--workdir" in capsys.readouterr().err


# ------------------------------------------------------------------- BERT --

def test_convert_hf_bert_matches_jax():
    kw = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=40)
    cfg = TextEncoderConfig(**kw)
    rng = np.random.default_rng(5)
    E, F = cfg.hidden_size, cfg.intermediate_size
    sd = {"embeddings.word_embeddings.weight": (cfg.vocab_size, E),
          "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, E),
          "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, E),
          "embeddings.LayerNorm.weight": (E,), "embeddings.LayerNorm.bias": (E,)}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (E, E)), ("attention.self.key", (E, E)),
                            ("attention.self.value", (E, E)),
                            ("attention.output.dense", (E, E)),
                            ("intermediate.dense", (F, E)), ("output.dense", (E, F))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = shape, (shape[0],)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = (E,), (E,)
    sd = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in sd.items()}
    sd["pooler.dense.weight"] = torch.zeros(E, E)      # HF extras are ignored

    got = BertEncoder(cfg, dtype=torch.float32)
    got.load_state_dict(convert_hf_bert(sd, cfg))
    tree = jax_convert_hf_bert(sd, JaxTextConfig(**kw))
    want = load_params(BertEncoder(cfg, dtype=torch.float32),
                       {k: v for k, v in tree.items()})
    for (k, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k
