"""The data-parallel export: two gloo ranks on the CPU
(``tests/torch_dp_ranks.py``, task ``export``) at the verify recipe's
widths, on ``tests/test_torch_export.py``'s synthetic vocabulary of 48
codes and on its first 5 codes (one step for two ranks: a rank with no
step still joins the gather and the barrier).

- ``export_all(dp=)`` unpacked (batches of 14, so the padded tail batch
  falls to rank 1) and ``export_all_packed(dp=)`` (two 64-token rows a
  step, so the sweep takes several groups): the ranks' arrays bitwise
  equal to each other and to a world-1 run of the same task (one thread
  count), and held to the JAX export on a 2-device virtual CPU mesh under
  ``compare_exports``;
- ``cli.export --mesh-dp -1`` under the two ranks writes one set of files,
  from rank 0, equal to the one-device CLI's;
- ``--mesh-dp 3`` in a world of 2, and ``--mesh-dp 2`` without a launcher,
  are argparse errors; under a launcher without a GPU and without
  ``--device`` the CLI stops before joining a group.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtok_tpu.config import DataConfig as JaxDataConfig
from medtok_tpu.data.dataset import MedCodeDataset as JaxDataset
from medtok_tpu.data.dataset import collate as jax_collate
from medtok_tpu.data.synthetic import synthetic_kg as jax_synthetic_kg
from medtok_tpu.data.synthetic import synthetic_vocab_frame
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu.export.export import _export_all_packed
from medtok_tpu.export.export import export_all as jax_export_all
from medtok_tpu.export.parity import compare_exports
from medtok_tpu.models.tokenizer_model import MultimodalTokenizer as JaxTokenizer
from medtok_tpu.parallel.mesh import make_mesh
from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import save_npz
from medtok_tpu_torch.data.dataset import write_jsonl
from medtok_tpu_torch.models.graph_encoder import DENSE_ADJ_MIN_NODES
from tests.test_model import tiny_config
from tests.test_torch_export import DATA, KG_NODES, N_CODES, PACK, _synthetic, _vocab
from tests.test_torch_export_routes import _assert_tokens_agree
from tests.torch_dp_ranks import spawn_ranks

WORLD = 2
BATCH = 14      # 48 codes: 4 batches, the last (padded) on rank 1; 5 codes: one
TINY = 5        # codes of the small vocabulary
NAMES = ("embeddings_all", "tokens_all", "weights_all")


def write_kg_csv(kg, path) -> None:
    names = [f"rel_{r}" for r in kg.rel_index]
    with open(path, "w") as f:
        f.write("x_index,y_index,display_relation\n")
        f.writelines(map("{},{},{}\n".format, kg.edge_src.tolist(), kg.edge_dst.tolist(),
                         names))


@pytest.fixture(scope="module")
def dp_export(tmp_path_factory):
    """The files, the JAX weights and exports on a 2-device mesh, and the
    ranks' results: two ranks and one, the same task."""
    root = tmp_path_factory.mktemp("dp_export")
    rng = np.random.default_rng(0)
    df = synthetic_vocab_frame(rng, num_codes=N_CODES, num_kg_nodes=KG_NODES,
                               max_pkg_nodes=DENSE_ADJ_MIN_NODES)
    jkg = jax_synthetic_kg(rng, num_nodes=KG_NODES, num_edges=30_000, local_frac=0.7)
    cols, kg = _synthetic()
    vocab = _vocab()
    (root / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
    write_kg_csv(kg, root / "kg.csv")
    codes = {}
    for name, n in (("full", N_CODES), ("tiny", TINY)):
        df.iloc[:n].to_parquet(root / f"{name}.parquet")
        write_jsonl({k: v[:n] for k, v in cols.items()}, root / f"{name}.jsonl")
        codes[name] = str(root / f"{name}.jsonl")

    jcfg = dataclasses.replace(
        tiny_config(), max_text_length=64,
        graph=dataclasses.replace(tiny_config().graph, num_nodes=KG_NODES))
    jmodel = JaxTokenizer(jcfg)
    jds = {name: JaxDataset(jkg, root / f"{name}.parquet", JaxWordPiece(vocab),
                            cfg=JaxDataConfig(**DATA)) for name in codes}
    sample = jax.tree.map(jnp.asarray, jax_collate([jds["full"][0]], jds["full"].cfg))
    variables = jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=False))(sample)
    save_npz(jax.tree.map(np.asarray, variables["params"]), root / "params.npz")
    MedTokConfig.from_dict({"model": dataclasses.asdict(jcfg),
                            "data": DATA}).save(root / "args.json")
    files = ["--config", str(root / "args.json"), "--params", str(root / "params.npz"),
             "--kg", str(root / "kg.csv"), "--codes", codes["full"],
             "--vocab", str(root / "vocab.txt"), "--device", "cpu"]
    spec = dict(config=str(root / "args.json"), params=str(root / "params.npz"),
                kg=str(root / "kg.csv"), vocab=str(root / "vocab.txt"), codes=codes,
                batch_size=BATCH, pack=PACK,
                cli_argv=[*files, "--mesh-dp", "-1", "--packed", "off", "--batch-size",
                          str(BATCH)])
    # the two runs of the ranks go on while this process runs the JAX exports
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(spawn_ranks, "export", world, root / f"ranks{world}",
                            dict(spec, cli_out=str(root / f"cli{world}")))
                for world in (WORLD, 1)]
        mesh = make_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
        params, usage = variables["params"], variables["usage"]
        jax_dirs = {}
        for name, ds in jds.items():
            jax_dirs[(name, False)] = root / f"jax_{name}_unpacked"
            jax_export_all(jmodel, params, usage, ds, batch_size=BATCH, mesh=mesh,
                           out_dir=jax_dirs[(name, False)], packed=False)
            jax_dirs[(name, True)] = root / f"jax_{name}_packed"
            _export_all_packed(jmodel, params, usage, ds, mesh=mesh,
                               out_dir=jax_dirs[(name, True)],
                               **(PACK if name == "full" else {}))
        ranks, (one,) = (r.result() for r in runs)
    return dict(root=root, ranks=ranks, one=one, jax_dirs=jax_dirs, files=files)


CASES = [(name, packed) for name in ("full", "tiny") for packed in (False, True)]


def _same_bits(a: dict, b: dict) -> bool:
    return all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
               and a[k].tobytes() == b[k].tobytes() for k in NAMES)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'packed' if p else 'unpacked'}"
                                             for n, p in CASES])
def test_ranks_agree_bitwise_with_one_rank(dp_export, case):
    ranks, one = dp_export["ranks"], dp_export["one"]
    n = N_CODES if case[0] == "full" else TINY
    assert ranks[0][case]["arrays"]["tokens_all"].shape[0] == n
    for r in ranks:
        assert _same_bits(r[case]["arrays"], ranks[0][case]["arrays"])
    assert _same_bits(ranks[0][case]["arrays"], one[case]["arrays"])
    # every step ran once, on one rank; the tiny vocabulary has fewer steps
    # than ranks, so rank 1 runs none
    steps = [r[case]["steps"] for r in ranks]
    assert sum(steps) == one[case]["steps"]
    assert steps[0] - steps[1] in (0, 1)
    if case[0] == "tiny":
        assert steps == [1, 0]
    else:
        assert min(steps) >= 2


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'packed' if p else 'unpacked'}"
                                             for n, p in CASES])
def test_dp_export_matches_the_jax_mesh_export(dp_export, case, tmp_path):
    got = dp_export["ranks"][1][case]["arrays"]
    for name, arr in got.items():
        np.save(tmp_path / f"{name}.npy", arr)
    report = compare_exports(dp_export["jax_dirs"][case], tmp_path)
    assert report["num_codes"] == (N_CODES if case[0] == "full" else TINY)
    want = {name: np.load(dp_export["jax_dirs"][case] / f"{name}.npy") for name in NAMES}
    _assert_tokens_agree(got, want)
    differ = int((got["tokens_all"] != want["tokens_all"]).any(axis=(1, 2)).sum())
    assert report["embeddings_all"]["rows_outside_tol"] <= differ


def test_cli_rank_zero_writes_the_one_device_files(dp_export, tmp_path):
    root, ranks = dp_export["root"], dp_export["ranks"]
    assert ranks[0]["saves"] == [str(root / "cli2")] and ranks[1]["saves"] == []
    assert sorted(p.name for p in (root / "cli2").iterdir()) == sorted(
        f"{name}.npy" for name in NAMES)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)       # the ranks' thread count
    try:
        want = export_cli.main([*dp_export["files"], "--packed", "off", "--batch-size",
                                str(BATCH), "--out-dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    written = {name: np.load(root / "cli2" / f"{name}.npy") for name in NAMES}
    assert _same_bits(written, want)
    for r in ranks:
        assert _same_bits(r["cli"], want)
    assert _same_bits(dp_export["one"]["cli"], want)


def test_mesh_dp_other_than_the_world_is_an_error(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(SystemExit) as e:
        export_cli.main(["--workdir", "missing", "--mesh-dp", "3", "--device", "cpu"])
    assert e.value.code == 2 and "the world size is 2" in capsys.readouterr().err


def test_mesh_dp_without_a_launcher_names_torchrun(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        export_cli.main(["--workdir", "missing", "--mesh-dp", "2", "--device", "cpu"])
    assert e.value.code == 2 and "torchrun --nproc-per-node 2" in capsys.readouterr().err


def test_dp_cli_without_a_gpu_stops_before_loading(monkeypatch, tmp_path):
    """Under a launcher's environment and without --device, a machine with
    no GPU stops before joining a group or reading a file."""
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--workdir", str(tmp_path / "missing"), "--mesh-dp", "-1"])
    assert not dist.is_initialized()
