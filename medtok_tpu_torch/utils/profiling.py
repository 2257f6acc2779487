"""Tracing and step timing (counterpart of ``medtok_tpu/utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where the
  build has it, the CUDA activity, written into ``logdir`` as a Chrome
  trace (``*.pt.trace.json``; TensorBoard's profiler plugin and
  chrome://tracing read it);
- ``annotate(name)``: a named range in that trace (``record_function``:
  the export's ``export.*`` and the trainer's ``train.*`` ranges are such);
- ``StepTimer``: steps/sec and per-step latency, the device synchronized
  at each boundary.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str | Path):
    """``with trace('prof/') as prof: step(...)``: profiles the block and,
    on leaving it, writes ``<host>_<pid>.<ms>.pt.trace.json`` into
    ``logdir`` (made if missing). Yields the ``torch.profiler.profile``, so
    the caller may read ``key_averages()`` too."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    wanted = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    activities = [a for a in wanted if a in torch.profiler.supported_activities()]
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return record_function(name)


def _synchronize(x) -> None:
    """Wait for the devices of the CUDA tensors in ``x`` (a tensor, or a
    list, tuple or dict of them), as ``jax.block_until_ready`` waits for its
    arrays."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _synchronize(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _synchronize(v)


class StepTimer:
    """steps/sec with the device synchronized at the measurement
    boundaries: ``start(sync_on=t)`` / ``stop(sync_on=t)`` wait for the
    devices of the tensors ``t`` before reading the clock."""

    def __init__(self):
        self._times: list[float] = []
        self._t0: float | None = None

    def start(self, sync_on=None) -> None:
        if sync_on is not None:
            _synchronize(sync_on)
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            _synchronize(sync_on)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / np.mean(self._times) if self._times else 0.0

    def summary(self) -> dict:
        """steps_per_sec and the mean, median and p99 step in ms ({} before
        any step)."""
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps_per_sec": float(1.0 / t.mean()),
            "step_ms_mean": float(t.mean() * 1e3),
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p99": float(np.percentile(t, 99) * 1e3),
        }
