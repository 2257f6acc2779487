"""Device time of the operations launched under the program's
``train.allreduce`` range on rank 0 (the data-parallel step's all-reduce of
the trainable gradients and of the metrics: NCCL's collective kernels
across the cards), in ms a training step. A one-process run opens no such
range: nothing is read."""

MOVES = "train_codes_per_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"] or "train.allreduce" not in tr.range_device_s:
        return None
    return 1e3 * tr.range_device_s["train.allreduce"] / ctx["steps"]
