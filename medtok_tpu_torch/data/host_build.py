"""Builds the host C++ runtime under ``medtok_tpu_torch/csrc/host/`` at first
use: the graph packer (``medtok_graph.cpp``) and the WordPiece tokenizer
(``wordpiece.cpp``), each a shared library with a plain C interface loaded
with ``ctypes``.

Each library is built by one ``g++`` call with ``GXX_FLAGS`` into
``medtok_tpu_torch/_build/`` under a name keyed by a hash of its source, the
flags and the target ``-march=native`` resolves to on this host, so an
unchanged tree reuses it and a changed source or another CPU rebuilds. The
compiler writes a temporary file that is renamed into place, so processes
that build at once never load a half-written library. A failed build raises
with the compiler's message: there is no silent fall-back to the numpy
route (``MedCodeDataset(native=False)`` asks for that route by name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
GXX = "g++"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_target: str | None = None


def _target_options() -> str:
    """What ``-march=native`` resolves to here (``g++ -Q --help=target``)."""
    global _target
    if _target is None:
        try:
            run = subprocess.run([GXX, "-march=native", "-Q", "--help=target"],
                                 capture_output=True, text=True, timeout=120)
        except OSError as e:
            raise RuntimeError(f"{GXX} was not found ({e}); the host runtime of "
                               "medtok_tpu_torch needs a C++17 compiler") from None
        if run.returncode != 0:
            raise RuntimeError(f"{GXX} -march=native failed:\n{run.stderr}")
        _target = run.stdout
    return _target


def library_path(name: str) -> Path:
    """Where the library of ``csrc/host/<name>.cpp`` is built."""
    h = hashlib.sha256(" ".join([GXX, *GXX_FLAGS]).encode())
    h.update(_target_options().encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(src: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        run = subprocess.run([GXX, *GXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{GXX} failed to build {src.name} "
                               f"(exit {run.returncode}):\n{run.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cpp``, built first if this
    tree and host have none."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build(SRC_DIR / f"{name}.cpp", path)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
