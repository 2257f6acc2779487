"""Turn a JAX training workdir into the params file of the PyTorch export.

    python scripts/jax_workdir_to_npz.py --workdir results/<experiment> \
        --out params.npz [--step S]

Runs where JAX and orbax are installed (the JAX package's own environment).
It restores the latest step of ``<workdir>/checkpoints/`` (or step ``S``),
a directory that ``medtok_tpu.utils.checkpoint.CheckpointManager`` wrote
with orbax's ``PyTreeCheckpointer``, and keeps the two collections that
``medtok_tpu/cli/export.py`` exports from: ``params`` and ``usage`` (the
quantizer's usage FIFO and counts). They are written as one ``.npz`` keyed
by ``/``-joined paths (``params/text_model/...``, ``usage/quantize/...``),
the layout of ``medtok_tpu_torch.convert.save_npz``, with numpy alone: the
script needs no torch. Then the port exports the JAX-trained model on one
card or under torchrun:

    python -m medtok_tpu_torch.cli.export --config results/<experiment>/args.json \
        --params params.npz --kg primeKG/ --codes codes.parquet --vocab vocab.txt

The step is restored without a target. ``CheckpointManager.save`` hands
orbax the train state as host numpy arrays, so the raw restore returns the
state's fields as a dict under their own names (``step``, ``params``,
``opt_state``, ``usage``, ``ema_params``, ``rng``) and no target has to be
built; a checkpoint without ``params`` stops the script with the names it
holds.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {``/``-joined path: array}."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def step_dirs(workdir: Path) -> list[int]:
    """The saved steps of a JAX workdir, oldest first."""
    ckpt = workdir / "checkpoints"
    if not ckpt.is_dir():
        raise FileNotFoundError(f"no checkpoints directory under {workdir}")
    return sorted(int(p.name) for p in ckpt.iterdir() if p.is_dir() and p.name.isdigit())


def convert(workdir: str | Path, out: str | Path, step: int | None = None) -> tuple[int, int]:
    """Restore ``step`` (default: the latest) of ``workdir`` and write its
    params and usage to ``out``; returns the step and the number of arrays."""
    import orbax.checkpoint as ocp

    workdir = Path(workdir)
    steps = step_dirs(workdir)
    if not steps:
        raise FileNotFoundError(f"no orbax step directories under {workdir / 'checkpoints'}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"no step {step} under {workdir / 'checkpoints'}: "
                                f"saved steps {steps}")
    state = ocp.PyTreeCheckpointer().restore((workdir / "checkpoints" / f"{step:07d}").absolute())
    if not isinstance(state, Mapping) or "params" not in state:
        names = sorted(state) if isinstance(state, Mapping) else type(state).__name__
        raise ValueError(f"step {step} of {workdir} holds no params collection: {names}")
    arrays = flatten({"params": state["params"], "usage": state.get("usage") or {}})
    np.savez(out, **arrays)
    return step, len(arrays)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="JAX training workdir (args.json + "
                                                    "checkpoints/)")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", type=int, default=None, help="default: the latest step")
    args = p.parse_args(argv)
    # a raw restore of host arrays needs no accelerator
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from medtok_tpu.utils.platform import apply_platform_env

    apply_platform_env()
    step, n = convert(args.workdir, args.out, args.step)
    print(f"wrote {n} arrays of step {step} of {args.workdir} to {args.out}")


if __name__ == "__main__":
    main()
