"""Device time of the operations launched under the program's
``export.bert`` range (the frozen BERT over the packed rows, K2 inside), in
ms a packed export step."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "export.bert" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["export.bert"] / ctx["steps"]
