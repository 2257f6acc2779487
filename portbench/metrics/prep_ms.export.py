"""Host time of an export call outside its steps: the program's
``export.plan`` range (entry to the first step: the model's device move,
the layout and buckets, the output buffers, ``warm_cache``, the group list)
and ``export.finish`` (the gather and save of the three arrays), each
divided by its own calls, in ms a call."""

MOVES = "export_codes_per_s"
RANGES = ("export.plan", "export.finish")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not all(tr.range_calls.get(r) for r in RANGES):
        return None
    return 1e3 * sum(tr.range_host_s[r] / tr.range_calls[r] for r in RANGES)
