"""Readings for the limits of a cell's output check: on each seed, the
program's numbers (a short window, then the check, as in a run) and, in the
same process, the control's (the reference in the program's place at the
precision below the configuration's) or a fault's (planted in the program):

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5 \\
        [--fault unchanged_state|half_batch|altered_token]

One JSON line a seed. Runs on the card (``--device cpu`` for tests).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def readings(cell, seed: int, seconds: float, device: str, fault: str | None) -> dict:
    import torch

    from portbench.faults import FAULTS

    planted = FAULTS[fault]() if fault else contextlib.nullcontext()
    run = cell.driver().Run(cell.config, cell.traffic, seed, device)
    with planted:
        run.setup()
        run.window(seconds, False)
    run.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "fault" if fault else "program": run.check()}
    if not fault:
        out["control"] = run.control()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    from medtok_tpu_torch.utils.platform import apply_platform_env

    apply_platform_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(args.workload, harness.load_json(CHECKOUT / "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, args.device, args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
