"""The mesh flags of the port's export and QA CLIs beside the JAX CLIs'.

``cli.export`` takes ``--mesh-dp`` (default -1) and ``cli.qa`` takes
``--mesh-dp`` / ``--mesh-tp`` (default 1), as the JAX CLIs do; -1 and 1 run
on one device. Above 1, either CLI without a process group of the mesh's
size stops at parse time, naming the torchrun launch. The
smallest input that failed before (``cli.qa finetune --data d.json
--embedding-path e.npy --mesh-dp 1 --mesh-tp 1``: "unrecognized arguments")
parses to the JAX parser's values.
"""

import pytest

from medtok_tpu.cli import export as jax_export_cli
from medtok_tpu.cli import qa as jax_qa_cli
from medtok_tpu_torch.cli import export as export_cli
from medtok_tpu_torch.cli import qa as qa_cli

QA_ARGV = ["finetune", "--data", "d.json", "--embedding-path", "e.npy"]


@pytest.mark.parametrize("mesh", [[], ["--mesh-dp", "1", "--mesh-tp", "1"],
                                  ["--mesh-dp", "-1"], ["--mesh-dp", "4", "--mesh-tp", "2"]])
def test_qa_parser_takes_the_jax_mesh_flags(mesh):
    argv = [*QA_ARGV, *mesh]
    got = vars(qa_cli.build_parser().parse_args(argv))
    want = vars(jax_qa_cli.build_parser().parse_args(argv))
    shared = set(got) & set(want)
    assert {"mesh_dp", "mesh_tp", "mode", "data", "lora_r", "cutoff_len"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


@pytest.mark.parametrize("mesh", [["--mesh-dp", "2"], ["--mesh-tp", "2"]])
def test_qa_mesh_above_one_raises_before_reading(mesh, capsys):
    with pytest.raises(SystemExit) as e:
        qa_cli.main([*QA_ARGV, "--tiny", "--device", "cpu", *mesh])
    assert e.value.code == 2 and "torchrun --nproc-per-node 2" in capsys.readouterr().err


@pytest.mark.parametrize("mesh", [[], ["--mesh-dp", "-1"], ["--mesh-dp", "1"]])
def test_export_parser_takes_the_jax_mesh_flag(mesh, tmp_path):
    """Both CLIs parse the flags and stop at the missing workdir's
    args.json, the same error on both sides."""
    argv = ["--workdir", str(tmp_path / "missing"), *mesh]
    with pytest.raises(FileNotFoundError) as want:
        jax_export_cli.main(argv)
    with pytest.raises(FileNotFoundError) as got:
        export_cli.main([*argv, "--device", "cpu"])
    assert got.value.filename == want.value.filename


def test_export_mesh_above_one_raises_before_reading(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        export_cli.main(["--workdir", str(tmp_path / "missing"), "--mesh-dp", "2",
                         "--device", "cpu"])
    assert e.value.code == 2 and "torchrun --nproc-per-node 2" in capsys.readouterr().err
