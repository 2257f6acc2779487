"""Device time of the operations launched under the program's
``export.text`` range (a text encoder other than the BERT, here
DeepSeek-V2, over the packed rows), in ms a packed export step."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "export.text" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["export.text"] / ctx["steps"]
