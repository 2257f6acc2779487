"""The 90th percentile of the window's step times, each from one ``log_fn``
call to the next (``log_every`` 1: the metrics' copy to the host
synchronizes every step), in ms; the steps the profiler ran in, started or
stopped in are left out."""

import numpy as np

MOVES = "train_codes_per_s"


def read(ctx):
    ms = ctx["step_ms"]
    return float(np.percentile(ms, 90)) if ms else None
