"""Tracing, counters and step timing (counterpart of
``medtok_tpu/utils/profiling.py``):

- ``span(name)``: a named range in a ``torch.profiler`` trace while a
  profiler runs (``record_function``), else a shared no-op context (a
  check of ``torch.autograd._profiler_enabled``, about 0.1 us, where an
  idle ``record_function`` costs about 10 us on a CPU). Every range of the
  port opens through it: the export's ``export.*`` (``export.plan`` /
  ``export.finish`` around each call's set-up and return), the trainer's
  ``train.*`` (``train.draw`` / ``pack`` / ``to_device`` / ``metrics`` /
  ``checkpoint`` around each host phase of ``fit``) and ``gcn_norm_adj``.
  Kineto records them on the clock of the CUDA device events, so a device
  gap can be put down to a host range. ``annotate`` is the JAX package's
  name for it;
- ``count(name, n)`` / ``counters()``: one registry of named running
  totals, always on, each taken where the host already holds the number:
  ``native.pack_s`` / ``native.fence_wait_s`` (the C++ packer's calls and
  its waits on pinned-pool fences), ``text.encode_s`` / ``text.store_s``
  (the bulk WordPiece encode and the text store's insert), and the padded
  shapes' fill as real / slot pairs: ``text.tokens`` / ``text.slots``
  (packed BERT rows), ``graph.nodes`` / ``graph.node_slots`` and
  ``graph.edges`` / ``graph.edge_slots`` (each built batch, every view the
  graph encoder runs; repeat-padding codes are slots, not real),
  ``quantize.codes`` / ``quantize.code_slots`` (the packed export's groups
  against their code buckets), and ``gelu.kernel_elems`` / ``gelu.elems``
  (the bf16 gelu elements the kernel took, of all, ``ops/gelu.py``), and
  ``moe.pairs`` / ``moe.pair_slots`` (the DeepSeek-V2 encoder's
  token-expert pairs of real tokens, of all slots routed);
- ``device_count(name, t)`` / ``read_device_counts()``: totals kept on the
  device, added to only while a profiler runs (``device_counting``;
  ``moe.expert_load.<layer>``: the real tokens each expert of a MoE layer
  took) and read, and cleared, once
  by the tracer when its block closes: an untraced run pays nothing;
- ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where the
  build has it, the CUDA activity, written into ``logdir`` as a Chrome
  trace (``*.pt.trace.json``; TensorBoard's profiler plugin and
  chrome://tracing read it), and beside it ``counters.json``, the
  registry's change over the traced block and the device totals;
- ``StepTimer``: steps/sec and per-step latency, the device synchronized
  at each boundary.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

_IDLE = contextlib.nullcontext()
_COUNTS: dict[str, float] = {}
_COUNTS_LOCK = threading.Lock()
_DEVICE_COUNTS: dict[str, torch.Tensor] = {}


def span(name: str):
    """``with span("export.plan"): ...``: a ``record_function`` range while
    a profiler runs, else a no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _IDLE


annotate = span


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the running total ``name`` (made at 0)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, float]:
    """A snapshot of every running total."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def device_counting() -> bool:
    """Whether ``device_count`` counts now (a profiler runs): a caller
    computes what it would add only then."""
    return torch.autograd._profiler_enabled()


def device_count(name: str, values: torch.Tensor) -> None:
    """While a profiler runs, add ``values`` (integers, on any device) into
    the device-side total ``name`` (made at 0, of the same shape), with no
    host read; else nothing."""
    if not device_counting():
        return
    with _COUNTS_LOCK:
        acc = _DEVICE_COUNTS.get(name)
        if acc is None:
            _DEVICE_COUNTS[name] = values.detach().to(torch.int64, copy=True)
        else:
            acc += values


def read_device_counts() -> dict[str, list]:
    """The device-side totals as lists (one copy to the host each), then
    cleared."""
    with _COUNTS_LOCK:
        out = {k: v.tolist() for k, v in sorted(_DEVICE_COUNTS.items())}
        _DEVICE_COUNTS.clear()
    return out


@contextlib.contextmanager
def trace(logdir: str | Path):
    """``with trace('prof/') as prof: step(...)``: profiles the block and,
    on leaving it, writes ``<host>_<pid>.<ms>.pt.trace.json`` and
    ``counters.json`` (each counter's change over the block, those that
    moved, and the device totals of ``read_device_counts``) into ``logdir``
    (made if missing). Yields the
    ``torch.profiler.profile``, so the caller may read ``key_averages()``
    too."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    wanted = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    activities = [a for a in wanted if a in torch.profiler.supported_activities()]
    before = counters()
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
    delta = {k: v - before.get(k, 0) for k, v in sorted(counters().items())
             if v != before.get(k, 0)}
    delta.update(read_device_counts())
    (logdir / "counters.json").write_text(json.dumps(delta, indent=1) + "\n")


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
