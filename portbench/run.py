"""Run one cell of the benchmark once on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It sets up the cell (its data from the seed, the program, its weights, the
warm-up), measures for ``--seconds`` seconds, reads the device, frees the
program, holds what the window produced to the plain reference, and prints
the result as the last line of standard output (``portbench/README.md``).
Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.Cell(args.workload, harness.load_json(CHECKOUT / "BENCHMARK.json"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"portbench: {args.workload} needs {cell.spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import medtok_tpu_torch

    here = Path(medtok_tpu_torch.__file__).resolve()
    if CHECKOUT not in here.parents:
        print(f"portbench: the program was imported from {here}, outside this checkout",
              file=sys.stderr)
        return 2
    from medtok_tpu_torch.utils.platform import apply_platform_env

    # what the port's entry points run first: the allocator setting, and fp32
    # products in full fp32
    apply_platform_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
