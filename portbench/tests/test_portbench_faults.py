"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.
The chip look is skipped (the CPU route, tiny sizes, fp32); the limits are
the cells' own."""

from __future__ import annotations

import time

import pytest

from portbench import faults, harness
from portbench.tests import tiny


def run(name: str, fault: str | None = None) -> dict:
    cell = tiny.cell(name, limits=harness.Cell(
        name, harness.load_json(harness.CHECKOUT / "BENCHMARK.json")).limits)
    planted = faults.FAULTS[fault]() if fault else None
    if planted is None:
        return harness.run_cell(cell, seed=2**32 + 17, seconds=0.5, trace=False,
                                device="cpu", t0=time.perf_counter())
    with planted:
        return harness.run_cell(cell, seed=2**32 + 17, seconds=0.5, trace=False,
                                device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("name", ["export-gcn", "train-gcn", "train-gat"])
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name, fault", [
    ("export-gcn", "altered_token"),
    ("train-gcn", "unchanged_state"), ("train-gcn", "half_batch"),
    ("train-gcn", "altered_token"),
    ("train-gat", "unchanged_state"), ("train-gat", "half_batch"),
    ("train-gat", "altered_token")])
def test_fault_is_not_correct(name, fault):
    res = run(name, fault)
    assert not res["correct"], res["checks"]
