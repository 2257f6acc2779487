"""The train and QA CLIs on a tensor-parallel mesh: two gloo ranks on the
CPU, ``--mesh-tp 2`` (dp 1), at the verify recipe's widths and files.

- ``cli.train`` (GCN, ``--kmeans --codebook-revival``, a checkpoint every
  step) to step 2, resumed with ``--workdir`` to step 3: args.json records
  the mesh, the two ranks save bitwise the same state (generators too: one
  dp block), and the losses are the one-device run's (in process, same
  flags but the mesh) within 1e-5;
- ``cli.qa finetune --tiny --mesh-tp 2`` on the first QA_ROWS rows of
  tests/fixtures/medmcqa_200.json: the losses are the one-device
  run's within 1e-4 relative; rank 0 writes the adapter in the one-device
  layout (the same files, names and shapes, values within rtol 1e-3 / atol
  1e-6), and the adapter loads into a one-device ``QAFinetuner``, whose
  loss on a batch is that of the one-device adapter within 1e-5;
- ``cli.qa eval --mesh-dp 2`` (greedy): each dp block answers its share of
  every batch and the ranks return the one-device run's predictions, in
  order, and its accuracy.
"""

import json

import numpy as np
import pytest
import torch

from medtok_tpu_torch.cli import qa as qa_cli
from medtok_tpu_torch.cli import train as train_cli
from medtok_tpu_torch.qa import finetune
from medtok_tpu_torch.qa.inference import extend_with_miss_rows
from medtok_tpu_torch.qa.llama import TINY_LLAMA
from medtok_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_qa_cli import FIXTURE, FLAGS
from tests.test_torch_train_cli import TINY, _data_flags, files  # noqa: F401
from tests.torch_dp_ranks import spawn_ranks

WORLD = 2
QA_ROWS = 48      # three batches of 16


def _mesh(flags: list, *mesh) -> list:
    i = flags.index("--mesh-dp")
    return [*flags[:i], *flags[i + 2:], *mesh]


@pytest.fixture(scope="module")
def tp_cli(files, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("tp_cli")
    np.save(root / "emb.npy", np.random.default_rng(0).normal(size=(300, 256))
            .astype(np.float32))
    (root / "qa.json").write_text(json.dumps(json.loads(FIXTURE.read_text())[:QA_ROWS]))

    def argvs(tag, *mesh):
        train = [*_data_flags(files), "--epochs", "3", "--ckpt-every", "1", "--device", "cpu",
                 "--results-dir", str(root / f"results_{tag}"), "--kmeans",
                 "--codebook-revival", *_mesh(TINY, *mesh)]
        data = ["--data", str(root / "qa.json"), "--embedding-path", str(root / "emb.npy"),
                *FLAGS]
        qa = ["finetune", *data, "--adapter-path", str(root / f"adapter_{tag}"), *mesh]
        return train, qa, ["eval", *data, "--temperature", "0"]

    train, qa, qa_eval = argvs("tp", "--mesh-dp", "-1", "--mesh-tp", "2")
    ranks = spawn_ranks("tp_cli", WORLD, root / "ranks", dict(
        argv=train, qa_argv=qa, qa_eval_argv=[*qa_eval, "--mesh-dp", "2"]))
    train, qa, qa_eval = argvs("one")
    one = dict(workdir=train_cli.main([*train, "--max-steps", "3"]),
               qa_losses=qa_cli.main(qa)["losses"], qa_eval=qa_cli.main(qa_eval))
    return root, ranks, one


def test_train_ranks_save_one_state_and_args_json_records_the_mesh(tp_cli):
    _, ranks, _ = tp_cli
    workdir = ranks[0]["workdir"]
    assert {r["workdir"] for r in ranks} == {r["again"] for r in ranks} == {workdir}
    cfg = json.loads((CheckpointManager(workdir).workdir / "args.json").read_text())
    assert (cfg["train"]["mesh_dp"], cfg["train"]["mesh_tp"]) == (-1, 2)
    assert sorted(ranks[0]["saved"]) == sorted(ranks[1]["saved"]) == [1, 2, 3]
    for step in (1, 2, 3):
        a, b = (r["saved"][step] for r in ranks)
        for k, v in a.items():
            if k == "mu":
                assert all(torch.equal(x, y) for x, y in zip(v, b[k]))
            else:
                assert torch.equal(v, b[k]), (step, k)
    log = (CheckpointManager(workdir).workdir / "log.txt").read_text()
    assert log.count(f"data parallel: {WORLD} ranks over gloo as a mesh of dp 1 x tp 2") == 2


def test_train_losses_are_the_one_device_runs(tp_cli):
    _, ranks, one = tp_cli

    def losses(workdir):
        lines = open(CheckpointManager(workdir).workdir / "metrics.jsonl")
        return [json.loads(line)["loss"] for line in lines]

    got, want = losses(ranks[0]["workdir"]), losses(one["workdir"])
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, rel=1e-5)


def test_qa_adapter_is_the_one_device_layout_and_loads(tp_cli):
    root, ranks, one = tp_cli
    for r in ranks:
        assert r["qa_losses"] == pytest.approx(one["qa_losses"], rel=1e-4)
    assert len(one["qa_losses"]) == QA_ROWS // 16
    tp, ref = (torch.load(root / f"adapter_{t}" / "lora_params.pt") for t in ("tp", "one"))
    assert tp.keys() == ref.keys()
    for name, v in ref.items():
        assert tp[name].shape == v.shape, name
        np.testing.assert_allclose(tp[name].numpy(), v.numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(np.load(root / "adapter_tp" / "projector.npy"),
                                  tp["soft_prompt.projector.weight"].numpy().T)

    table = extend_with_miss_rows(np.load(root / "emb.npy"), num_miss_rows=100)
    cfg = finetune.QAFinetuneConfig(lora_rank=2, cutoff_len=16, total_len=16 + 64)
    rows = [dict(input_ids=[1] * 16 + list(range(20, 30)), attention_mask=[1] * 26,
                 labels=list(range(21, 31))) for _ in range(2)]
    batch = finetune._collate_rows(rows, cutoff_len=16)
    loss = {}
    for tag, adapter in (("tp", tp), ("one", ref)):
        ft = finetune.QAFinetuner(TINY_LLAMA, table, cfg, device="cpu")
        ft.init_params()
        with torch.no_grad():
            for name, p in ft.named_parameters():
                if name in adapter:
                    p.copy_(adapter[name])
            loss[tag] = float(ft.loss_fn(batch))
    assert loss["tp"] == pytest.approx(loss["one"], rel=1e-5)


def test_qa_eval_over_dp_blocks_is_the_one_device_eval(tp_cli):
    _, ranks, one = tp_cli
    assert len(one["qa_eval"]["predictions"]) == QA_ROWS
    for r in ranks:
        assert r["qa_eval"]["predictions"] == one["qa_eval"]["predictions"]
        assert r["qa_eval"]["accuracy"] == one["qa_eval"]["accuracy"]
