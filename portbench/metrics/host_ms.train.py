"""Host time of a training step outside the step itself: the program's
``train.draw`` (the batch build with its edge dropout), ``train.pack``
(the packed text) and ``train.to_device`` (the batch's copies) ranges, in
ms a step. Packs and copies are divided by their own calls. The profiler
starts inside the first traced step's draw (not recorded) and stops inside
the draw after the last (recorded up to the stop, microseconds), so the
draws' sum holds the traced steps less one whole draws."""

MOVES = "train_codes_per_s"
RANGES = ("train.draw", "train.pack", "train.to_device")


def read(ctx):
    tr = ctx["trace"]
    whole_draws = ctx["steps"] - 1
    if tr is None or whole_draws < 1 or not all(tr.range_calls.get(r) for r in RANGES):
        return None
    return 1e3 * (tr.range_host_s["train.draw"] / whole_draws
                  + sum(tr.range_host_s[r] / tr.range_calls[r] for r in RANGES[1:]))
