"""Device time of the graph encoders, forward and backward, in ms a
training step: the operations launched under the program's ``train.gcn``
ranges (both graph encoders, GCN or GAT, and both views run under that
name) and those of the autograd nodes those ranges created."""

MOVES = "train_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "train.gcn" not in tr.range_device_s:
        return None
    both = tr.range_device_s["train.gcn"] + tr.backward_device_s.get("train.gcn", 0.0)
    return 1e3 * both / ctx["steps"]
