"""Device time of the operations launched under the program's ``text.mla``
ranges (each DeepSeek-V2 layer's input RMSNorm and multi-head latent
attention: projections, RoPE, the causal segment attention, the output
projection), in ms a packed export step."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "text.mla" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["text.mla"] / ctx["steps"]
