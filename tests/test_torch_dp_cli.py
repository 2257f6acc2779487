"""The train and EHR CLIs data parallel: two gloo ranks on the CPU at the
verify recipe's widths (``tests/test_torch_train_cli.py``'s files and
flags, ``--mesh-dp -1``), and the flags' errors.

- ``cli.train`` (GCN, ``--kmeans --codebook-revival``, a checkpoint every
  step) to step 2, resumed with ``--workdir`` to step 3: one experiment
  directory (rank 0's name), one args.json, one log and one
  ``metrics.jsonl`` line a step, checkpoints written by rank 0 alone with
  both ranks' generator states; every rank restores the state it saved
  (its own generator state too) and the ranks hold one state but for
  their generators; ``cli.export --workdir`` reads the workdir;
- ``cli.ehr`` on the synthetic MIMIC-III tables: the ranks report the same
  validation and test metrics, rank 0 writes them;
- under a launcher's ``WORLD_SIZE=2``: a ``--mesh-dp`` other than -1 or 2,
  ``--mesh-tp 2``, a global batch 2 does not divide, and an EHR batch 2
  does not divide raise; ``--mesh-dp 2`` and ``--multihost`` parse.
"""

import json

import numpy as np
import pytest
import torch

from medtok_tpu_torch.cli import ehr as ehr_cli
from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.cli import train as train_cli
from medtok_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_ehr_chain import TINY as EHR_TINY
from tests.test_torch_ehr_chain import workspace  # noqa: F401
from tests.test_torch_train_cli import N_CODES, TINY, _data_flags, files  # noqa: F401
from tests.torch_dp_ranks import spawn_ranks

WORLD = 2


def _any_mesh(flags: list) -> list:
    i = flags.index("--mesh-dp")
    return [*flags[:i + 1], "-1", *flags[i + 2:]]


@pytest.fixture(scope="module")
def dp_cli(files, workspace, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("dp_cli")
    argv = [*_data_flags(files), "--epochs", "3", "--ckpt-every", "1", "--device", "cpu",
            "--results-dir", str(root / "results"), "--kmeans", "--codebook-revival",
            *_any_mesh(TINY)]
    ehr_argv = ["--dataset", "MIMIC_III", "--task", "readmission",
                "--ehr-root", str(workspace / "SYN"), "--med-codes",
                str(workspace / "codes.jsonl"), "--embedding-path", str(workspace / "emb.npy"),
                "--epochs", "2", "--save-result-path", str(root / "ehr"),
                *_any_mesh(EHR_TINY)]
    ranks = spawn_ranks("cli", WORLD, root / "ranks",
                        dict(argv=argv, ehr_argv=ehr_argv))
    return root, ranks


def test_rank_zero_writes_one_run(dp_cli):
    root, ranks = dp_cli
    workdir = ranks[0]["workdir"]
    assert {r["workdir"] for r in ranks} == {r["again"] for r in ranks} == {workdir}
    assert [str(p) for p in (root / "results").iterdir()] == [workdir]
    assert ranks[0]["saves"] == [(0, 1), (0, 2), (0, 2), (0, 3), (0, 3)]
    assert ranks[1]["saves"] == []
    mgr = CheckpointManager(workdir)
    assert mgr.steps() == [2, 3]
    ck = mgr.load(3)
    assert len(ck["generators"]) == WORLD and torch.equal(ck["generators"][0], ck["generator"])
    assert not torch.equal(ck["generators"][0], ck["generators"][1])
    steps = [json.loads(line)["step"] for line in open(mgr.workdir / "metrics.jsonl")]
    assert steps == [1, 2, 3]
    log = (mgr.workdir / "log.txt").read_text()
    assert log.count(f"data parallel: {WORLD} ranks over gloo") == 2
    assert log.count("kmeans codebook init done") == 1
    assert log.count("Resumed from the checkpoint at step 2") == 1


def test_every_rank_restores_what_it_saved(dp_cli):
    _, ranks = dp_cli
    for r in ranks:
        saved, started = r["states"]["saved 2"], r["states"]["started 2"]
        assert saved.keys() == started.keys()
        for k, v in saved.items():
            if k == "mu":
                assert all(torch.equal(a, b) for a, b in zip(v, started[k]))
            elif isinstance(v, torch.Tensor):
                assert torch.equal(v, started[k]), k
            else:
                assert v == started[k], k
    a, b = (r["states"]["saved 3"] for r in ranks)
    for k, v in a.items():
        if k == "generator":
            assert not torch.equal(v, b[k])     # each rank its own dropout masks
        elif k == "mu":
            assert all(torch.equal(x, y) for x, y in zip(v, b[k]))
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k


def test_export_reads_the_dp_workdir(dp_cli, tmp_path):
    _, ranks = dp_cli
    arrays = export_cli.main(["--workdir", ranks[0]["workdir"], "--device", "cpu",
                              "--batch-size", "8", "--out-dir", str(tmp_path)])
    assert arrays["embeddings_all"].shape == (N_CODES, 64)
    assert np.isfinite(arrays["embeddings_all"]).all()


def test_ehr_cli_ranks_agree(dp_cli):
    root, ranks = dp_cli
    a, b = (json.dumps(r["ehr"], sort_keys=True) for r in ranks)   # NaN == NaN
    assert a == b
    written = json.loads((root / "ehr" / "test_metrics.json").read_text())
    assert json.dumps({k: written[k] for k in ("best_val", "test")}, sort_keys=True) == \
        json.dumps({k: ranks[0]["ehr"][k] for k in ("best_val", "test")}, sort_keys=True)
    lines = [json.loads(line) for line in open(root / "ehr" / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [0, 1, 2]


TRAIN_ERRORS = {
    "mesh-dp": (["--mesh-dp", "4"], "the world size is 2"),
    "mesh-dp-1": (["--mesh-dp", "1"], "the world size is 2"),
    # --mesh-tp 2 fits the world of 2; a mesh of 4 ranks names its launch
    "mesh-tp": (["--mesh-dp", "2", "--mesh-tp", "2"], "torchrun --nproc-per-node 4"),
    "batch": (["--global-batch-size", "7"], "not divisible by the world size 2"),
}


@pytest.mark.parametrize("name", list(TRAIN_ERRORS))
def test_train_flag_errors_under_a_launcher(name, monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    extra, what = TRAIN_ERRORS[name]
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--text-vocab", "v.txt", *extra])
    assert e.value.code == 2 and what in capsys.readouterr().err


def test_train_flags_accepted_under_a_launcher(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    for extra in ([], ["--mesh-dp", "2"], ["--mesh-dp", "-1", "--multihost"],
                  ["--mesh-tp", "2"], ["--mesh-dp", "1", "--mesh-tp", "2"]):
        args = train_cli.parse_args(["--text-vocab", "v.txt", *extra])
        assert args.mesh_dp * args.mesh_tp in (-args.mesh_tp, WORLD)


@pytest.mark.parametrize("extra,what", [(["--batch-size", "7"], "not divisible by the world "
                                         "size 2"),
                                        (["--mesh-dp", "4"], "the world size is 2")])
def test_ehr_flag_errors_under_a_launcher(extra, what, monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    if extra[0] == "--batch-size":      # an argparse error, before any data is read
        with pytest.raises(SystemExit) as e:
            ehr_cli.main([*extra, "--device", "cpu"])
        assert e.value.code == 2 and what in capsys.readouterr().err
    else:
        with pytest.raises(ValueError, match=what):
            ehr_cli.main([*extra, "--device", "cpu"])
