"""The share of the traced export window in which no device operation ran
(the window less the union of the operations' intervals), in %."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
