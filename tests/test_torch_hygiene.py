"""The port stands alone and refuses to hide the device: no imports of JAX
or of the JAX package, entry points that raise without CUDA unless given a
device, a kernel build that raises without nvcc, and a chip_smoke.py that
fails without a GPU or without the repository beside it."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import medtok_tpu_torch
from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "medtok_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "medtok_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the package's own name is not the JAX package's
    assert "medtok_tpu_torch" not in FORBIDDEN
    assert _imported_roots(REPO / "medtok_tpu_torch" / "export.py") >= {"medtok_tpu_torch"}


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")

    from medtok_tpu_torch.cli import export as cli
    from medtok_tpu_torch.export import export_all_packed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_all_packed(None, None)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", missing, "--params", missing, "--kg", missing,
                  "--codes", missing, "--vocab", missing])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--workdir", missing])

    from medtok_tpu_torch.api import MedTok
    from medtok_tpu_torch.cli import train as train_cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--text-vocab", missing, "--workdir", missing])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MedTok.from_checkpoint(missing, None)

    from medtok_tpu_torch.ehr.train import EHRTrainConfig, EHRTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        EHRTrainer(EHRTrainConfig(), np.zeros((4, 256), np.float32), 2)

    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(MedTokConfig())

    # the A/B scripts run on the card unless given --device
    from medtok_tpu_torch.scripts import bench_adj, profile_bert

    for script in (bench_adj, profile_bert):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main([])


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.load_library()
    assert not (tmp_path / "build").exists()
    # K3's launch path (what its wrappers run for CUDA tensors) builds
    # first and raises, with no fall-back to the plain version
    from medtok_tpu_torch.ops import flash_attention as fa

    for entry in ("medtok_flash_fwd", "medtok_flash_dq", "medtok_flash_dkv"):
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            fa._k3_launch(entry, None, None, (), 0.25, 0.0, 0)
    # so do the launch paths of K2 / K4 and of K5 / K5-lane
    from medtok_tpu_torch.ops import adj_count as ac

    for entry in ("medtok_segment_attention", "medtok_segment_attention_nt"):
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            fa._segment_launch(entry, None, None, None, None, None, 12, None)
    for entry in ("medtok_adj_count", "medtok_adj_count_onehot"):
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            ac._count_launch(entry, None, None, None, None, 4, 16)
    assert not (tmp_path / "build").exists()


def test_kernel_sources_are_packaged():
    names = {p.name for p in _build._sources()}
    assert {"topk_l2.cu", "segment_attention.cu", "flash_attention.cu",
            "adj_count.cu"} <= names
    assert {"medtok_flash_fwd", "medtok_flash_dq", "medtok_flash_dkv",
            "medtok_segment_attention_nt", "medtok_adj_count",
            "medtok_adj_count_onehot"} <= set(_build._SIGNATURES)
    # every registered entry point is defined in a packaged source
    sources = "".join(p.read_text() for p in _build._sources())
    assert all(f" {name}(" in sources for name in _build._SIGNATURES)
    assert _build._library_path().parent == _build.BUILD_DIR
    assert "medtok_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    assert Path(medtok_tpu_torch.__file__).parent / "csrc" == _build.SRC_DIR


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    run = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
