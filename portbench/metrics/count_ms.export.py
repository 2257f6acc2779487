"""Device time of the operations launched under the program's
``gcn_norm_adj`` range (the GCN's dense-adjacency Count and its
normalization), in ms a packed export step. A GAT model has no such range:
nothing is read."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "gcn_norm_adj" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["gcn_norm_adj"] / ctx["steps"]
