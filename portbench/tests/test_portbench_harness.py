"""The harness: what it imports, how it finds a cell's files, and that it
does not run without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

CHECKOUT = harness.CHECKOUT
PORTBENCH_MODULES = [
    "portbench.run", "portbench.harness", "portbench.check", "portbench.counts",
    "portbench.datagen", "portbench.trace", "portbench.tracing_hooks", "portbench.weights",
    "portbench.control", "portbench.drivers.export", "portbench.drivers.train",
    "portbench.reference.medtok"]
# the program's modules the drivers import when a cell is set up
PROGRAM_MODULES = [
    "medtok_tpu_torch.config", "medtok_tpu_torch.data.dataset", "medtok_tpu_torch.data.kg",
    "medtok_tpu_torch.data.text", "medtok_tpu_torch.export",
    "medtok_tpu_torch.models.tokenizer_model", "medtok_tpu_torch.train.trainer",
    "medtok_tpu_torch.models.bert", "medtok_tpu_torch.ops.vq"]
REFERENCE_MODULES = ["portbench.reference.medtok", "portbench.check", "portbench.counts",
                     "portbench.datagen"]


def loaded_after(modules: list[str]) -> list[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_in_the_harness_or_the_program_it_drives():
    tops = {m.split(".")[0] for m in loaded_after(PORTBENCH_MODULES + PROGRAM_MODULES)}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    assert "medtok_tpu_torch" in tops


def test_reference_imports_nothing_of_the_port():
    tops = {m.split(".")[0] for m in loaded_after(REFERENCE_MODULES)}
    assert not tops & (set(harness.FORBIDDEN) | {"medtok_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "medtok_tpu_torch_extra", sys)
    assert "medtok_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_a_new_cell_is_found_by_name_without_a_code_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(CHECKOUT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "portbench/traffic/export.json").read_text())
    traffic["codes_per_call"] = 4096
    (root / "portbench/traffic/export-small.json").write_text(json.dumps(traffic))
    (root / "portbench/limits/export-gcn.small.json").write_text(
        json.dumps({"token_gap": {"limit": 0.5}}))
    (root / "portbench/metrics/calls.export.py").write_text(
        "MOVES = 'export_codes_per_s'\n\ndef read(ctx):\n    return 1.0\n")
    bench["workloads"].append({"name": "export-gcn.small", "config": "medtok-gcn",
                               "traffic": "export-small", "chips": 1, "why": "smaller calls"})
    for m in bench["end_to_end"]:
        if m["name"] == "export_codes_per_s":
            m["workloads"].append("export-gcn.small")
    bench["per_layer"].append({"name": "calls.export", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "kernels",
                               "moves": "export_codes_per_s"})
    cell = harness.Cell("export-gcn.small", bench, root=root / "portbench")
    assert cell.traffic["codes_per_call"] == 4096
    assert cell.config["model"]["graph"]["model_name"] == "GCN"
    assert cell.limits == {"token_gap": {"limit": 0.5}}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "export_codes_per_s"]
    assert "calls.export" in [m["name"] for m in cell.per_layer]
    assert cell.reader("calls.export").read({}) == 1.0
    assert cell.driver().Run.__name__ == "Run"


def test_every_listed_metric_has_a_reader_that_names_what_it_moves():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = harness.load_module(harness.ROOT / "metrics" / f"{m['name']}.py", "m")
        assert mod.MOVES == m["moves"], m["name"]


def test_run_without_a_card_fails_and_prints_no_result():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'export-gcn', '--seed', '1', '--seconds', '1',"
            " '--trace', '0']\n"
            "sys.path.insert(0, 'portbench')\n"
            "import runpy\n"
            "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "export-gcn",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_file_names_are_unused_under_the_repository_tests():
    ours = {p.name for p in (CHECKOUT / "portbench" / "tests").glob("*.py")}
    theirs = {p.name for p in (CHECKOUT / "tests").rglob("*.py")}
    assert not (ours - {"__init__.py", "conftest.py"}) & theirs


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "export-gcn",
                          "--seed", "11", "--seconds", "5", "--trace", "0"], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
