"""The benchmark's own span around each draw from the ``epoch_batches``
iterator ``fit`` is handed (the native batch build with its edge dropout),
mean ms over the window's draws outside the profiled steps."""

MOVES = "train_codes_per_s"


def read(ctx):
    ms = ctx["host_batch_ms"]
    return sum(ms) / len(ms) if ms else None
