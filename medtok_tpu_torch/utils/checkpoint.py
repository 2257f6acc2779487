"""Training checkpoints with rotation, and the ``args.json`` freezing
contract (counterpart of ``medtok_tpu/utils/checkpoint.py``, in a torch
format of the port's own).

Layout of an experiment directory:

    args.json                    the run's MedTokConfig, written once
    checkpoints/0000500.pt       one file a saved step, the newest
    checkpoints/0001000.pt       ``max_to_keep`` kept

A checkpoint is one ``torch.save`` dict of plain containers and tensors, so
it loads with ``torch.load(weights_only=True)``:

    step          the step count
    model         the model's state_dict: every parameter, the frozen text
                  encoder's too (as the JAX package's ``state.params``)
    buffers       the buffers the state_dict leaves out (the quantizer's
                  non-persistent usage FIFO)
    adam          {"count", "mu", "nu"}: the trainable parameters' moments
    ema           the EMA of the trainable parameters, or None
    generator     the cross-attention dropout generator's state (rank 0's)
    pack_rows     the trainer's packed-row budget (fixed by the first batch)
    generators    data parallel only: every rank's generator state, in rank
                  order

Restoring all of it and drawing the same batches continues the run bit for
bit. A ``mirror_dir`` gets a copy of every checkpoint, never rotated.
A data-parallel run writes the same file from rank 0 (its ranks hold one
state but for their generators), so the readers take its workdir as one
from a single device.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import TYPE_CHECKING

import torch
from torch import nn

from medtok_tpu_torch.config import MedTokConfig

if TYPE_CHECKING:
    from medtok_tpu_torch.train.trainer import TrainState


class CheckpointManager:
    def __init__(self, workdir: str | Path, *, max_to_keep: int = 2,
                 config: MedTokConfig | None = None,
                 mirror_dir: str | Path | None = None):
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / "checkpoints"
        self.mirror_dir = Path(mirror_dir) if mirror_dir is not None else None
        if config is not None and not (self.workdir / "args.json").exists():
            self.workdir.mkdir(parents=True, exist_ok=True)
            config.save(self.workdir / "args.json")
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(p.stem) for p in self.ckpt_dir.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f"{step:07d}.pt"

    def save(self, state: "TrainState", *, pack_rows: int = 0,
             generators: list[torch.Tensor] | None = None) -> Path:
        """Write ``state`` as checkpoints/{step:07d}.pt (and into the
        mirror), then drop the oldest beyond ``max_to_keep``. ``generators``:
        a data-parallel run's generator states, one a rank."""
        model = state.model
        weights = model.state_dict()
        payload = {
            "step": int(state.step),
            "model": weights,
            "buffers": {n: b for n, b in model.named_buffers() if n not in weights},
            "adam": {"count": int(state.opt_state.count), "mu": list(state.opt_state.mu),
                     "nu": list(state.opt_state.nu)},
            "ema": None if state.ema_params is None else list(state.ema_params),
            "generator": state.generator.get_state(),
            "pack_rows": int(pack_rows),
        }
        if generators is not None:
            payload["generators"] = list(generators)
        path = self.path(state.step)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        _save_atomic(payload, path)
        if self.mirror_dir is not None:
            self.mirror_dir.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, self.mirror_dir / path.name)
        steps = self.steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            self.path(old).unlink()
        return path

    def load(self, step: int | None = None, *, map_location=None) -> dict:
        """The checkpoint dict of ``step`` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            orbax = sorted(p.name for p in self.ckpt_dir.glob("*")
                           if p.is_dir() and p.name.isdigit())
            if orbax:
                raise FileNotFoundError(
                    f"{self.ckpt_dir} holds orbax step directories ({', '.join(orbax)}) "
                    "of a JAX training run and no .pt checkpoint of the port: convert "
                    "one where JAX is installed with `python scripts/jax_workdir_to_npz.py "
                    f"--workdir {self.workdir} --out params.npz`, then export with "
                    f"`--config {self.workdir / 'args.json'} --params params.npz --kg ... "
                    "--codes ... --vocab ...`")
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def restore(self, state: "TrainState", step: int | None = None, *,
                payload: dict | None = None) -> tuple["TrainState", int]:
        """Load a checkpoint (``step``'s, or a ``payload`` the caller already
        loaded) into ``state`` in place (its model, Adam state, EMA and
        generator); returns the state and the saved packed-row budget."""
        dev = next(state.model.parameters()).device
        ck = self.load(step, map_location=dev) if payload is None else payload
        load_weights(state.model, ck)
        adam = ck["adam"]
        with torch.no_grad():
            state.opt_state.count = int(adam["count"])
            for dst, src in ((state.opt_state.mu, adam["mu"]), (state.opt_state.nu, adam["nu"])):
                _copy_list(dst, src, "Adam moments")
            if (ck["ema"] is None) != (state.ema_params is None):
                raise ValueError("the checkpoint's EMA and the config's TrainConfig.ema "
                                 "disagree")
            if state.ema_params is not None:
                _copy_list(state.ema_params, ck["ema"], "EMA")
        state.generator.set_state(ck["generator"].cpu())
        state.step = int(ck["step"])
        return state, int(ck["pack_rows"])

    @staticmethod
    def load_config(workdir: str | Path) -> MedTokConfig:
        """The run's config, from its args.json."""
        return MedTokConfig.load(Path(workdir) / "args.json")


def load_weights(model: nn.Module, ck: dict) -> nn.Module:
    """A checkpoint's state_dict and the buffers it leaves out into
    ``model`` (values cast to each tensor's dtype, so the training model's
    fp32 parameters load into the eval model's compute dtype too)."""
    model.load_state_dict(ck["model"], strict=True)
    with torch.no_grad():
        for name, value in ck["buffers"].items():
            model.get_buffer(name).copy_(value)
    return model


def _copy_list(dst: list[torch.Tensor], src: list[torch.Tensor], what: str) -> None:
    if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
        raise ValueError(f"the checkpoint's {what} do not match the model's trainable "
                         "parameters")
    for d, s in zip(dst, src):
        d.copy_(s)


def _save_atomic(payload: dict, path: Path) -> None:
    """torch.save to a temporary file beside ``path``, then rename it."""
    tmp = path.with_suffix(".pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
