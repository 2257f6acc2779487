"""Device time of the operations launched under the program's
``export.quantize`` range (text_mapped, the graph encoder with its Count,
the cross-attention and the four K1 sweeps), in ms a packed export step."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "export.quantize" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["export.quantize"] / ctx["steps"]
