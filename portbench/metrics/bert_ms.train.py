"""Device time of the operations launched under the program's
``train.bert`` range (the frozen BERT's forward over the packed rows, K2
inside; it takes no backward), in ms a training step."""

MOVES = "train_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "train.bert" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["train.bert"] / ctx["steps"]
