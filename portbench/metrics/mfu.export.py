"""The whole export's share of the card's bf16 dense peak: the model
operations the traced calls' codes need at their true sizes
(``counts.model_flops``) over the traced window's time, in %."""

from portbench.counts import PEAK_BF16

MOVES = "export_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * ctx["flops"] / (tr.window_s * PEAK_BF16)
