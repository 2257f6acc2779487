"""The control: the reference in the program's place at the precision below
the configuration's (float8 e4m3 products, TF32 distances) must come out
not correct. On the CPU at a tiny size its readings lie far above the
program's; on the card, at the cells' own sizes, it fails the cells'
limits (``portbench/control.py``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import control, harness
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["export-gcn", "train-gcn", "train-gat"])
def test_control_reads_far_above_the_program_on_the_cpu(name):
    got = control.readings(tiny.cell(name), 2**31 + 9, 0.5, "cpu", None)
    program, low = got["program"], got["control"]
    assert any(low[k] > 10 * max(program[k], 1e-6) for k in program), got


@pytest.mark.card
@pytest.mark.parametrize("name", ["export-gcn", "train-gcn", "train-gat"])
def test_control_fails_the_limits_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.Cell(name, harness.load_json(harness.CHECKOUT / "BENCHMARK.json")).limits
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", name,
                          "--seeds", "101,102,103", "--seconds", "5"], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.strip().splitlines():
        got = json.loads(line)
        assert all(v <= limits[k]["limit"] for k, v in got["program"].items()), got
        assert any(v > limits[k]["limit"] for k, v in got["control"].items()), got
