"""The routed experts' share of their roofline in the traced export: their
least time (``counts_dsv2.experts_bound_s``: in each MoE layer of a step,
the larger of the real token-expert pairs' three bf16 products at the bf16
peak and the stacked expert weights read once at the memory rate) over the
device time of the operations under the program's ``text.moe.experts``
ranges (the two grouped products and the SwiGLU between them), in %."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    spent = tr.range_device_s.get("text.moe.experts", 0.0) if tr is not None else 0.0
    if spent <= 0.0 or not ctx.get("experts_bound_s"):
        return None
    return 100.0 * ctx["experts_bound_s"] / spent
