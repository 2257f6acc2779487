"""The ``train-gcn.dp4`` driver on the CPU at a tiny size: four gloo ranks
through ``Trainer.fit`` against the reference's four-shard steps, the
shards' semantics themselves, and that the run ends non-zero soon when one
rank exits."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness, witness_dp
from portbench.drivers.train_dp import padded_to
from portbench.reference.medtok import Inputs
from portbench.tests import tiny


def dp_traffic(world: int = 4) -> dict:
    t = tiny.traffic("train")
    t.update(driver="train_dp", world=world, backend="nccl")
    t["train"]["mesh_dp"] = world
    return t


def test_four_gloo_ranks_agree_with_the_four_shard_reference():
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    cell = harness.Cell("train-gcn.dp4", bench, config=tiny.config(), traffic=dp_traffic(),
                        limits={})
    res = harness.run_cell(cell, seed=2**34 + 1, seconds=1.0, trace=False, device="cpu",
                           t0=time.perf_counter())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert set(checks) == {"loss_gap", "grad_gap", "update_gap", "fifo_gap"}
    assert checks["fifo_gap"] == 0.0
    # fp32 on both sides: sums in other orders (Adam's division amplifies
    # the smallest moments' rounding in update_gap)
    assert checks["loss_gap"] < 1e-4 and checks["grad_gap"] < 1e-4, checks
    assert checks["update_gap"] < 5e-3, checks
    assert res["device"]["count"] == 4 and res["attempted"] % 32 == 0


@pytest.mark.parametrize("fault,fails", [
    ("no_allreduce", {"grad_gap", "update_gap"}),
    ("no_gather", {"fifo_gap"}),
    ("half_batch", {"loss_gap", "fifo_gap"}),
])
def test_a_fault_fails_the_cells_limits(fault, fails):
    """Rank 0 keeping its own gradients (it joins the all-reduce and drops
    its result), or pushing its own indices alone into the usage FIFO, or
    every rank training on half its shard, reads above the cell's own
    limits."""
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    cell = witness_dp.cell("run", fault, bench, config=tiny.config(), traffic=dp_traffic())
    assert cell.traffic["backend"] == "gloo"
    with witness_dp.FAULTS[fault]():
        res = harness.run_cell(cell, seed=2**34 + 3, seconds=1.0, trace=False, device="cpu",
                               t0=time.perf_counter())
    above = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert not res["correct"] and fails <= above, res["checks"]


def test_the_witness_puts_every_rank_on_one_card_or_forms_nccl_alone():
    run, nccl1 = witness_dp.cell("run"), witness_dp.cell("nccl1")
    assert (run.traffic["world"], run.traffic["backend"]) == (4, "gloo")
    assert (nccl1.traffic["world"], nccl1.traffic["backend"]) == (1, "nccl")
    assert nccl1.traffic["train"]["mesh_dp"] == 1
    assert run.limits == nccl1.limits == harness.load_json(
        harness.ROOT / "limits" / "train-gcn.dp4.json")


def test_a_shard_is_padded_to_the_global_batch():
    """The reference's shard of a global batch: the rank's own codes, edge
    dropout and edges, at the global batch's text and node buckets with
    its flat node numbering widened."""
    from portbench.datagen import make_corpus

    corpus = make_corpus(dict(tiny.traffic("train")["corpus"], seed=3))
    inputs = Inputs(corpus, tiny.config()["data"], "cpu")
    codes = np.arange(64)
    full, part = inputs.batch(codes), inputs.batch(codes[16:32], aug_seed=77)
    got = padded_to(part, full)
    assert got.input_ids.shape == (16, full.input_ids.shape[1])
    assert got.node_ids.shape == (16, full.node_ids.shape[1])
    assert torch.equal(got.input_ids[:, :part.input_ids.shape[1]], part.input_ids)
    Ln, ln = full.node_ids.shape[1], part.node_ids.shape[1]
    assert torch.equal(got.edges // Ln, part.edges // ln)
    assert torch.equal(got.edges % Ln, part.edges % ln)
    assert torch.equal(got.edges_aug // Ln, part.edges_aug // ln)


KILL_ONE = """
import sys, time
sys.path.insert(0, {root!r})
from portbench.tests.test_portbench_train_dp import dp_traffic
from portbench.tests import tiny
from portbench.drivers.train_dp import Run
run = Run(tiny.config(), dp_traffic(), 5, "cpu")
run.setup()
run.procs[1].kill()
t0 = time.perf_counter()
run.window(300.0, False)
print("the window ran on", time.perf_counter() - t0)
"""


def test_a_dead_rank_ends_the_run_soon():
    """Rank 2 killed after set-up: the run exits non-zero within 120 s,
    and leaves no rank behind."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", KILL_ONE.format(root=str(harness.CHECKOUT))],
                         capture_output=True, text=True, timeout=240)
    # the watcher names the rank, or the collective it left raises first
    assert out.returncode != 0, out.stdout[-2000:]
    assert "the window ran on" not in out.stdout
    assert time.perf_counter() - t0 < 120


def test_the_cell_needs_four_cards():
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    spec = {w["name"]: w for w in bench["workloads"]}["train-gcn.dp4"]
    assert spec["chips"] == 4 and spec["config"] == "medtok-gcn"
    t = harness.load_json(harness.ROOT / "traffic" / "train-dp4.json")
    base = harness.load_json(harness.ROOT / "traffic" / "train.json")
    assert (t["world"], t["backend"], t["train"]["global_batch_size"]) == (4, "nccl", 1024)
    assert t["corpus"] == base["corpus"]
    assert {k: v for k, v in t["train"].items() if k != "mesh_dp"} == {
        k: v for k, v in base["train"].items() if k != "mesh_dp"}

