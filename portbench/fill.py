"""The program's fill counters as shares: a total of real entries over the
padded slots they sat in, read from the program's counter registry
(``medtok_tpu_torch/utils/profiling.py::counters``). The totals run over
the whole process (set-up, warm-up and window drive the same stationary
traffic), so the share does not depend on the window."""

from __future__ import annotations


def fill(real: str, slots: str) -> float | None:
    """100 x counters[real] / counters[slots], in %; None where the program
    keeps no such counters."""
    try:
        from medtok_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get(slots):
        return None
    return 100.0 * c.get(real, 0) / c[slots]
