"""The run's logger and metrics stream (own copy of
``medtok_tpu/utils/logging.py``): a logger writing to the console and to
``log.txt`` in the experiment directory, and ``MetricsLogger`` appending one
JSON object a logged step to ``metrics.jsonl``. The wandb mirror of the JAX
package is not ported (the GPU machine has no wandb; the train CLI refuses
``--wandb``).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any


def create_logger(logging_dir: str | Path | None) -> logging.Logger:
    """The ``medtok_tpu_torch`` logger with a console handler and, given a
    directory, a ``log.txt`` handler there (created if missing)."""
    logger = logging.getLogger("medtok_tpu_torch")
    logger.handlers.clear()
    logger.propagate = False  # no duplicate lines through the root logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if logging_dir is not None:
        Path(logging_dir).mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(Path(logging_dir) / "log.txt"))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class MetricsLogger:
    """Append-only ``metrics.jsonl``: ``{"step", "ts", **metrics}`` a line,
    flushed at once. ``workdir`` None writes nothing."""

    def __init__(self, workdir: str | Path | None):
        self._fh = None
        if workdir is not None:
            Path(workdir).mkdir(parents=True, exist_ok=True)
            self._fh = open(Path(workdir) / "metrics.jsonl", "a")

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        clean = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                 for k, v in metrics.items()}
        if self._fh is not None:
            self._fh.write(json.dumps({"step": step, "ts": time.time(), **clean}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
