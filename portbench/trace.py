"""Reduction of a torch.profiler trace of the traced window: which device
operations ran, for how long, under which of the program's
``record_function`` ranges they were launched, where the device sat idle
and what the host was doing then.

A device operation is matched to the runtime call that launched it (one
CUDA correlation id) and so to a place on the host timeline. Inside a
range it counts for that range (and for every range enclosing it). Inside
an autograd node's evaluation it is the backward of the range whose
forward op created the node (matched by the autograd sequence number).
"""

from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field

WINDOW_RANGE = "portbench.window"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list = field(default_factory=list)    # (name, start_us, end_us)
    range_device_s: dict = field(default_factory=dict)      # forward, by range name
    backward_device_s: dict = field(default_factory=dict)   # backward, by range name
    range_host_s: dict = field(default_factory=dict)        # host time, by range name
    range_calls: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)           # (host range, seconds)

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the operations whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in names)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, s, e in self.device_ops:
            by[name] += (e - s) / 1e6
        return [[k[:120], v] for k, v in by.most_common(n)]


class _Intervals:
    """Sorted, non-overlapping intervals of one name: which holds t."""

    def __init__(self, evs):
        self.evs = sorted(evs, key=lambda e: e.time_range.start)
        self.starts = [e.time_range.start for e in self.evs]

    def holding(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t <= self.evs[k].time_range.end:
            return self.evs[k]
        return None


def reduce(prof, range_prefixes: tuple[str, ...]) -> Trace:
    """The Trace of a profile whose window is the ``portbench.window`` range.
    ``range_prefixes`` name the program's ranges to attribute to."""
    import torch

    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    host = [e for e in events if e.device_type == cpu]
    windows = [e for e in host if e.name == WINDOW_RANGE]
    if not windows:
        raise RuntimeError("the trace holds no portbench.window range")
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    out = Trace(window_s=(w1 - w0) / 1e6)

    def ours(name):
        return name.startswith(range_prefixes)

    runtime = {e.id: e for e in host if re.match(r"cu(da)?[A-Z]", e.name)}
    ops = [e for e in events if e.device_type == gpu
           and not getattr(e, "is_user_annotation", False)
           and not ours(e.name) and e.name != WINDOW_RANGE]
    ranges = [e for e in host if ours(e.name)]
    by_name = collections.defaultdict(list)
    for e in ranges:
        by_name[e.name].append(e)
        out.range_host_s[e.name] = out.range_host_s.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
        out.range_calls[e.name] = out.range_calls.get(e.name, 0) + 1
    tables = {name: _Intervals(evs) for name, evs in by_name.items()}
    backward = _Intervals([e for e in ranges if e.name.endswith(".backward")])
    nodes = _Intervals([e for e in host
                        if e.name.startswith("autograd::engine::evaluate_function")])
    # the forward range each autograd sequence number was created under
    forward_tables = {n: t for n, t in tables.items() if not n.endswith(".backward")}
    seq_range: dict[int, set] = {}
    for e in host:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            for name, table in forward_tables.items():
                if table.holding(e.time_range.start) is not None:
                    seq_range.setdefault(e.sequence_nr, set()).add(name)
    fwd = collections.Counter()
    bwd = collections.Counter()
    intervals = []
    for k in ops:
        s, t_end = k.time_range.start, k.time_range.end
        if t_end < w0 or s > w1:
            continue
        s, t_end = max(s, w0), min(t_end, w1)
        intervals.append((s, t_end))
        out.device_ops.append((k.name, s, t_end))
        launch = runtime.get(k.id)
        if launch is None:
            continue
        t = launch.time_range.start
        dur = (t_end - s) / 1e6
        inside = [n for n, table in forward_tables.items() if table.holding(t) is not None]
        if inside:
            for n in inside:
                fwd[n] += dur
        else:
            node = nodes.holding(t)
            if node is not None and backward.holding(t) is not None:
                for n in seq_range.get(node.sequence_nr, ()):
                    bwd[n] += dur
    out.range_device_s = dict(fwd)
    out.backward_device_s = dict(bwd)
    # busy time: the union of the device operations' intervals
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out.busy_s = sum(e - s for s, e in merged) / 1e6
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:10]:
        open_ = [n for n, table in tables.items() if table.holding(s) is not None]
        label = min(open_, key=lambda n: (tables[n].holding(s).time_range.end
                                          - tables[n].holding(s).time_range.start)) \
            if open_ else "outside the program's ranges"
        out.idle_gaps.append([label, (e - s) / 1e6])
    return out
