"""Host seconds a packed export step spends in the program's
``export.pack_text``, ``export.make_batch`` and ``export.to_device`` ranges
(the host side of the trace), in ms a step."""

MOVES = "export_codes_per_s"
RANGES = ("export.pack_text", "export.make_batch", "export.to_device")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"]:
        return None
    return 1e3 * sum(tr.range_host_s.get(r, 0.0) for r in RANGES) / ctx["steps"]
