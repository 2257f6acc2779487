"""``train-gcn.dp4`` where four cards are not to hand: its driver with every
rank over gloo on card 0 (``run``), a world-1 NCCL run that forms the
NCCL group and runs the step's collectives (``nccl1``), or the readings
that set the cell's limits (``readings``: on each seed the program's
numbers and the control's, or a fault's planted on rank 0):

    python3 portbench/witness_dp.py run --seed N --seconds 51 --trace 1
    python3 portbench/witness_dp.py nccl1 --seed N --seconds 20 --trace 1
    python3 portbench/witness_dp.py readings --seeds 1,2,3 \\
        [--fault half_batch|no_allreduce|no_gather]

``run`` and ``nccl1`` print the harness's result line; ``readings`` one
JSON line a seed. The faults:

- ``half_batch``: ``faults.half_batch`` planted on every rank (the
  traffic's ``fault_every_rank``), so the global batch is halved as on
  one card and the FIFO's gather keeps one shape on all ranks;
- ``no_allreduce``: rank 0 alone joins the step's all-reduces and keeps
  its own gradients and metrics, so its step is its shard's alone;
- ``no_gather``: rank 0 alone joins the usage FIFO's gather and pushes its
  own indices alone.

A fault on rank 0 alone keeps every collective of the step, so the other
ranks run on as they would.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

T0 = time.perf_counter()
CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import faults  # noqa: E402


def no_allreduce():
    from medtok_tpu_torch.parallel.mesh import DataParallel

    mean = DataParallel.all_reduce_mean_

    def own(self, tensors, axis="dp"):
        return mean(self, [t.clone() for t in tensors], axis)

    return faults._patched(DataParallel, "all_reduce_mean_", own)


def no_gather():
    from medtok_tpu_torch.models.quantizer import SoftVQQuantizer

    track = SoftVQQuantizer._track_usage

    def own(self, indices):
        if self.dp is None or not self.cfg.show_usage:
            return track(self, indices)
        self.dp.all_gather(indices, axis="dp")
        dp, self.dp = self.dp, None
        try:
            return track(self, indices)
        finally:
            self.dp = dp

    return faults._patched(SoftVQQuantizer, "_track_usage", own)


FAULTS = {**faults.FAULTS, "no_allreduce": no_allreduce, "no_gather": no_gather}


#: the faults every rank plants (the others: rank 0 alone)
EVERY_RANK = ("half_batch",)


def cell(mode: str, fault: str | None = None, bench: dict | None = None, **given):
    """The ``train-gcn.dp4`` cell with its ranks on one card over gloo, or
    (``nccl1``) at world 1 over NCCL, its traffic carrying ``fault`` where
    every rank plants it; ``given`` as ``harness.Cell`` takes."""
    from portbench import harness

    bench = bench or harness.load_json(CHECKOUT / "BENCHMARK.json")
    traffic = given.pop("traffic", None) or harness.Cell("train-gcn.dp4", bench).traffic
    if mode == "nccl1":
        traffic = dict(traffic, world=1, train=dict(traffic["train"], mesh_dp=1))
    else:
        traffic = dict(traffic, backend="gloo")
    if fault in EVERY_RANK:
        traffic["fault_every_rank"] = fault
    return harness.Cell("train-gcn.dp4", bench, traffic=traffic, **given)


def readings(c, seed: int, seconds: float, device: str, fault: str | None) -> dict:
    """``control.readings`` of the cell ``c`` (made by ``cell`` with the
    same fault), rank 0 planting ``fault``."""
    from portbench import control

    with mock.patch.dict(faults.FAULTS, FAULTS):
        return control.readings(c, seed, seconds, device, fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("run", "nccl1", "readings"))
    p.add_argument("--seed", type=int)
    p.add_argument("--seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    from medtok_tpu_torch.utils.platform import apply_platform_env

    apply_platform_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cell(args.mode, args.fault)
    if args.mode == "readings":
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(readings(c, seed, args.seconds, args.device, args.fault)),
                  flush=True)
        return 0
    res = harness.run_cell(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           device=args.device, t0=T0)
    harness.emit(res)
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
