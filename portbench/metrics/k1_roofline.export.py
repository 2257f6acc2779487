"""K1's share of its roofline in the traced export: the least time of every
sweep it was given (``counts.k1_bound_s`` from each launch's shapes) over
the device time of K1's kernels, by name, in %."""

MOVES = "export_codes_per_s"
KERNELS = ("tf32_split_kernel", "topk_tf32_kernel", "topk_merge_kernel",
           "wide_split_kernel", "topk_wide_kernel", "radix_select_kernel")


def read(ctx):
    tr = ctx["trace"]
    spent = tr.kernel_s(*KERNELS) if tr is not None else 0.0
    if spent <= 0.0:
        return None
    return 100.0 * ctx["k1_bound_s"] / spent
