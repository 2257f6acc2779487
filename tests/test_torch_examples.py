"""The port's examples (``examples/quickstart_torch.py``,
``examples/downstream_torch.py``) run end to end with ``--device cpu`` at
their own sizes, each with its own checks (5 finite training losses and
the two APIs agreeing; EHR test metrics, two QA steps and an evaluation of
every question), and raise without a GPU when no device is named."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_on_cpu(tmp_path):
    out = load("quickstart_torch").main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert out["shapes"]["embeddings_all"] == (40, 64)
    assert out["shapes"]["tokens_all"] == (40, 4, 5)
    assert out["api_diff"] <= 2e-3
    assert (tmp_path / "exp" / "embeddings_all.npy").exists()


def test_downstream_on_cpu(tmp_path):
    out = load("downstream_torch").main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert out["ehr"]["samples"] > 0 and set(out["ehr"]["test"]) == {"auc", "aupr", "f1"}
    assert len(out["qa"]["losses"]) == 2 and 0 <= out["qa"]["accuracy"] <= 1


@pytest.mark.parametrize("name", ["quickstart_torch", "downstream_torch"])
def test_examples_raise_without_cuda(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(["--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
