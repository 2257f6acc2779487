"""K2's share of its roofline in the traced export: the least time of every
layer it was given (``counts.k2_bound_s`` from each launch's segment ids)
over the device time of K2's kernels, by name, in %."""

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    spent = tr.kernel_s("segment_attention") if tr is not None else 0.0
    if spent <= 0.0:
        return None
    return 100.0 * ctx["k2_bound_s"] / spent
