"""Device time of the operations launched under the program's
``text.moe.*`` ranges (each MoE layer's RMSNorm and gate, the sort and
permute of the token-expert pairs, the routed products, the weighted
combine, the shared experts), in ms a packed export step."""

MOVES = "export_codes_per_s"
RANGES = ("text.moe.gate", "text.moe.dispatch", "text.moe.experts", "text.moe.combine",
          "text.moe.shared")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or not any(r in tr.range_device_s for r in RANGES):
        return None
    return 1e3 * sum(tr.range_device_s.get(r, 0.0) for r in RANGES) / ctx["steps"]
