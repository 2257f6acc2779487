"""What every cell shares: finding a cell's files by name, loading the
per-layer metric readers, timing the set-up, the JAX check, the device
reading and the result line."""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # portbench/
CHECKOUT = ROOT.parent
#: top-level module names that may not be loaded in a run (compared whole:
#: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "medtok_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic, metrics and
    limits, each found by name under ``root``."""

    def __init__(self, name: str, bench: dict, root: Path = ROOT, **given):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name, self.root = name, root
        self.spec = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = given.get("config") or load_json(
            root.parent / configs[self.spec["config"]]["file"])
        self.traffic = given.get("traffic") or load_json(
            root / "traffic" / f"{self.spec['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        # a metric with a workloads list is read in those cells, one without
        # in every cell that reports the end-to-end metric it moves
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
        limits = root / "limits" / f"{name}.json"
        self.limits = given.get("limits") or (load_json(limits) if limits.exists() else {})

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['driver']}.py",
                           f"portbench_driver_{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict:
    """Set up, run the window, read the device, free the program, check the
    outputs against the reference."""
    import torch

    run = cell.driver().Run(cell.config, cell.traffic, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    window = run.window(seconds, trace)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell.spec["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    metrics = {}
    result = {"correct": False, "attempted": window["attempted"], "failed": window["failed"]}
    if trace:
        ctx = window["ctx"]
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = ctx["trace"]
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps}
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = run.check()
    checks = {}
    for name, value in readings.items():
        limit = cell.limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
    result["correct"] = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result.update(metrics=metrics, device=device_info, checks=checks)
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    its ``checks`` key last."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
