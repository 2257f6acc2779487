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
    files = sorted((REPO / "medtok_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py",
        REPO / "examples" / "downstream_torch.py"]
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


QA_FORBIDDEN = {"regex", "tokenizers", "transformers", "sklearn", "pyarrow"}


def _module_level_roots(path: Path) -> set[str]:
    """Roots imported by the module's top-level statements (not inside a
    function or class)."""
    roots = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_qa_needs_no_package_the_card_machine_lacks():
    """The GPU machine has no regex, tokenizers, transformers, scikit-learn,
    pyarrow or pandas: the QA path imports none of them (pandas only inside
    the .parquet reader)."""
    files = sorted((REPO / "medtok_tpu_torch" / "qa").glob("*.py")) + [
        REPO / "medtok_tpu_torch" / "cli" / "qa.py"]
    assert len(files) >= 13
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & QA_FORBIDDEN
                                            | _module_level_roots(f) & {"pandas"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_qa_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from medtok_tpu_torch.cli import qa as qa_cli
    from medtok_tpu_torch.qa.finetune import QAFinetuner
    from medtok_tpu_torch.qa.llama import TINY_LLAMA, LlamaModel, generate

    table = np.zeros((4, 256), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QAFinetuner(TINY_LLAMA, table)
    assert QAFinetuner(TINY_LLAMA, table, device="cpu").device == torch.device("cpu")
    model = LlamaModel(TINY_LLAMA)
    embeds, mask = torch.zeros(1, 3, TINY_LLAMA.hidden_size), torch.ones(1, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, embeds, mask, max_new_tokens=2)
    assert generate(model, embeds, mask, max_new_tokens=2, device="cpu").shape == (1, 2)
    missing = str(tmp_path / "missing")
    for mode in ("finetune", "eval"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qa_cli.main([mode, "--data", missing, "--embedding-path", missing, "--tiny"])


EHR_FORBIDDEN = {"sklearn", "pyarrow"}


def test_ehr_and_export_routes_need_no_package_the_card_machine_lacks():
    """The EHR downstream, the export CLI and the API import no pandas,
    scikit-learn or pyarrow at module level (pandas only inside the
    .parquet readers), nor JAX or the JAX package anywhere."""
    port = REPO / "medtok_tpu_torch"
    files = sorted((port / "ehr").glob("*.py")) + [
        port / "cli" / "ehr.py", port / "cli" / "export.py", port / "api.py",
        port / "export.py", port / "data" / "dataset.py"]
    assert len(files) >= 15
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & (EHR_FORBIDDEN | FORBIDDEN)
                                            | _module_level_roots(f) & {"pandas", "sklearn"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


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


def test_host_runtime_loads_only_the_ports_own_build():
    """The C++ host runtime is built from the port's copies under
    medtok_tpu_torch/csrc/host/ into medtok_tpu_torch/_build/ and loaded
    from there; no loader names a path outside the package (the JAX
    package's csrc/*.so included)."""
    from medtok_tpu_torch.data import host_build, native, native_text

    pkg = Path(medtok_tpu_torch.__file__).parent
    assert host_build.SRC_DIR == pkg / "csrc" / "host"
    assert host_build.BUILD_DIR == _build.BUILD_DIR == pkg / "_build"
    assert {p.name for p in host_build.SRC_DIR.glob("*.cpp")} == {"medtok_graph.cpp",
                                                                 "wordpiece.cpp"}
    # the nvcc build globs only the top level of csrc/
    assert not any(p.suffix == ".cpp" for p in _build._sources())
    loaded = [Path(native._load()._name), Path(native_text._load()._name)]
    for name, path in zip(("medtok_graph", "wordpiece"), loaded):
        assert path == host_build.library_path(name) and path.parent == pkg / "_build"
    for mod in (host_build, native, native_text):
        text = Path(mod.__file__).read_text()
        assert "parents[2]" not in text and "libmedtok_graph.so" not in text


def test_a_failing_compiler_raises_rather_than_taking_the_numpy_route(monkeypatch, tmp_path):
    from medtok_tpu_torch.config import DataConfig
    from medtok_tpu_torch.data import host_build, native, native_text
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer

    cc = tmp_path / "cc"
    cc.write_text('#!/bin/sh\ncase "$*" in *" -o "*) echo "cc: cannot compile here" >&2; '
                  'exit 1;; esac\necho "-march= x86-64"\n')
    cc.chmod(0o755)
    monkeypatch.setattr(host_build, "GXX", str(cc))
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build, "_target", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_text, "_lib", None)
    kg = KnowledgeGraph(np.array([0, 1]), np.array([1, 2]), np.zeros(2, np.int32),
                        {"r": 0}, 3)
    tok = WordPieceTokenizer({"[UNK]": 0, "[CLS]": 1, "[SEP]": 2, "[PAD]": 3, "a": 4})
    args = (kg, ["C0"], ["a"], [[0, 1]], tok)
    with pytest.raises(RuntimeError, match="cannot compile here"):
        MedCodeDataset(*args, cfg=DataConfig())
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="cannot compile here"):
        native_text.NativeWordPiece(tok)
    # the numpy route is taken only when asked for
    ds = MedCodeDataset(*args, cfg=DataConfig(), native=False)
    assert ds.native is None and ds.make_batch([0]).edge_weight.sum() == 1
    # no compiler at all raises too
    monkeypatch.setattr(host_build, "GXX", str(tmp_path / "missing-g++"))
    monkeypatch.setattr(host_build, "_target", None)
    with pytest.raises(RuntimeError, match="was not found"):
        MedCodeDataset(*args, cfg=DataConfig())
