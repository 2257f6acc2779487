"""Single-device tokenizer training (counterpart of
``medtok_tpu/train/trainer.py``).

A step runs the training forward (``MultimodalTokenizer.forward_train``)
and ``train/losses.py::assemble_losses``, back-propagates, clips the
trainable gradients by their global norm and takes an Adam step, as optax's
``clip_by_global_norm`` + ``adam`` compute them, then updates the optional
parameter EMA. The trainable parameters are all but the frozen text
encoder's: it gets no gradient and no optimizer state. The model holds fp32
parameters and computes in ``ModelConfig.compute_dtype``; the quantizer's
usage FIFO lives in its buffers and is written by each step.

    trainer = Trainer(cfg, workdir="results/run")   # on CUDA
    state = trainer.init_state()      # resumes from the workdir's latest checkpoint
    state = trainer.fit(state, epoch_batches(dataset, batch_size=1024), max_steps=n)

With a ``workdir``, ``fit`` saves a checkpoint every ``ckpt_every`` steps
(``utils/checkpoint.py``, rotated to ``max_checkpoints``) and ``init_state``
restores the latest one; ``cli/train.py`` is the command line around it.
Data-parallel training (``mesh_dp`` / ``mesh_tp`` above 1) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import load_params
from medtok_tpu_torch.data.packing import pack_code_batch
from medtok_tpu_torch.data.types import CodeBatch, PackedTextBatch
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.train.losses import assemble_losses
from medtok_tpu_torch.utils.checkpoint import CheckpointManager

ADAM_EPS = 1e-8


def trainable_parameters(model: MultimodalTokenizer) -> list[tuple[str, nn.Parameter]]:
    """(name, parameter) of everything but the frozen text encoder, in
    ``named_parameters`` order."""
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("text_model.")]


@dataclasses.dataclass
class AdamState:
    count: int                 # steps taken
    mu: list[torch.Tensor]     # first moments, one per trainable parameter
    nu: list[torch.Tensor]     # second moments


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adam(lr, b1, b2,
    eps=1e-8))`` over a list of parameters, in place.

    The clip takes the global norm over the given gradients and, where it
    is not below ``max_grad_norm``, scales every gradient by max_norm /
    norm; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it
    is not used. Adam's moments and bias corrections are optax's:
    mu_hat / (sqrt(nu_hat) + eps). A ``max_grad_norm`` of 0 turns the clip
    off."""

    def __init__(self, lr: float, b1: float, b2: float, max_grad_norm: float):
        self.lr, self.b1, self.b2, self.max_grad_norm = lr, b1, b2, max_grad_norm

    @staticmethod
    def init(params: list[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: AdamState) -> None:
        """Update ``params`` and ``state`` in place; ``grads`` are consumed."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        b1, b2 = self.b1, self.b2
        state.count += 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        # bias corrections in fp32, as optax computes 1 - decay**count
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(state.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(state.count))
        update = torch._foreach_div(state.mu, bc1)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-self.lr)


@dataclasses.dataclass
class TrainState:
    step: int
    model: MultimodalTokenizer      # parameters and the usage FIFO buffers
    opt_state: AdamState
    ema_params: list[torch.Tensor] | None   # EMA of the trainable parameters
    generator: torch.Generator      # the cross-attention's dropout masks


def create_train_state(cfg: MedTokConfig, model: MultimodalTokenizer, *,
                       params: Mapping | str | Path | None = None) -> TrainState:
    """A fresh state on the model's device. Parameters are drawn by
    ``init_random_`` from a generator seeded by ``TrainConfig.global_seed``,
    or loaded from ``params``: a flax params tree, a variables dict with
    its ``usage`` collection, or a .npz of either (``convert.load_params``).
    Adam's state starts at zero, the EMA as a copy of the parameters, the
    dropout generator at the seed + 1."""
    seed = cfg.train.global_seed
    dev = next(model.parameters()).device
    if params is None:
        init_random_(model, torch.Generator(device=dev).manual_seed(seed))
    else:
        load_params(model, params)
    trainable = [p for _, p in trainable_parameters(model)]
    ema = [p.detach().clone() for p in trainable] if cfg.train.ema else None
    return TrainState(step=0, model=model, opt_state=ClippedAdam.init(trainable),
                      ema_params=ema,
                      generator=torch.Generator(device=dev).manual_seed(seed + 1))


def _loss_fn(model: MultimodalTokenizer, batch: CodeBatch, cfg: MedTokConfig, *,
             packed: PackedTextBatch | None = None,
             generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total loss, metrics) of the training forward; writes the usage
    FIFO."""
    out = model.forward_train(batch, packed=packed, generator=generator)
    with record_function("train.losses"):
        breakdown = assemble_losses(
            out, shared_loss_beta=cfg.train.shared_loss_beta,
            specific_loss_lamb=cfg.train.specific_loss_lamb,
            entropy_loss_ratio=cfg.model.quantizer.entropy_loss_ratio,
        )
    return breakdown.total, breakdown.metrics


def make_train_step(cfg: MedTokConfig, model: MultimodalTokenizer
                    ) -> Callable[..., tuple[TrainState, dict]]:
    """The step ``(state, batch, packed=None) -> (state, metrics)`` on
    device tensors: forward, backward, clip + Adam, EMA. The state is
    updated in place and returned; the metrics are detached device
    scalars. The ``train.*`` ranges (here, in ``_loss_fn`` and in the
    model) name the step's parts in a torch.profiler trace."""
    t = cfg.train
    tx = ClippedAdam(t.lr, t.beta1, t.beta2, t.max_grad_norm)
    params = [p for _, p in trainable_parameters(model)]
    decay = t.ema_decay

    def step_fn(state: TrainState, batch: CodeBatch,
                packed: PackedTextBatch | None = None):
        model.train()
        for p in params:
            p.grad = None
        loss, metrics = _loss_fn(model, batch, cfg, packed=packed,
                                 generator=state.generator)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            tx.step(params, [p.grad for p in params], state.opt_state)
            if state.ema_params is not None:
                with torch.no_grad():
                    torch._foreach_mul_(state.ema_params, decay)
                    torch._foreach_add_(state.ema_params, params, alpha=1.0 - decay)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def packed_rows_budget(attention_mask: np.ndarray, row_len: int) -> int:
    """The automatic row budget of the packed text path: 1.3 times the
    rows the batch's tokens fill, at least 2."""
    return max(2, int(np.ceil(1.3 * attention_mask.sum() / row_len)))


class Trainer:
    """Host loop on one device (CUDA unless ``device`` names another;
    without a GPU ``device=None`` raises): packs each batch's texts when
    ``TrainConfig.packed_text`` is set, runs the step, every ``log_every``
    steps passes the metrics as floats with ``steps_per_sec`` to
    ``log_fn(step, metrics)``, and with a ``workdir`` saves a checkpoint
    every ``ckpt_every`` steps (``args.json`` written there once)."""

    def __init__(self, cfg: MedTokConfig, *, device=None, workdir: str | Path | None = None,
                 log_fn: Callable[[int, dict], None] | None = None):
        t = cfg.train
        if t.mesh_dp > 1 or t.mesh_tp > 1:
            raise NotImplementedError(
                f"mesh_dp={t.mesh_dp}, mesh_tp={t.mesh_tp}: training runs on one "
                "device (data-parallel training is ROADMAP Queue 1, tokenizer "
                "training variants)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MultimodalTokenizer(cfg.model, param_dtype=torch.float32,
                                         device=self.device)
        self.log_fn = log_fn
        self.step_fn = make_train_step(cfg, self.model)
        self.pack_rows = t.packed_rows_per_shard
        self.ckpt = None
        if workdir is not None:
            self.ckpt = CheckpointManager(workdir, max_to_keep=t.max_checkpoints, config=cfg)

    def init_state(self, params: Mapping | str | Path | None = None) -> TrainState:
        """A fresh state (random parameters from ``TrainConfig.global_seed``,
        or ``params`` as ``create_train_state`` takes them), then, when the
        workdir holds a checkpoint, the latest one restored into it."""
        state = create_train_state(self.cfg, self.model, params=params)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, self.pack_rows = self.ckpt.restore(state)
        return state

    def save(self, state: TrainState) -> Path | None:
        """Checkpoint ``state`` into the workdir (None without one)."""
        if self.ckpt is None:
            return None
        return self.ckpt.save(state, pack_rows=self.pack_rows)

    def pack(self, batch: CodeBatch) -> PackedTextBatch:
        """The batch's texts packed into the row budget (numpy); the budget
        of ``packed_rows_per_shard`` = 0 is fixed from the first batch."""
        t = self.cfg.train
        am = np.asarray(batch.attention_mask)
        if self.pack_rows == 0:
            self.pack_rows = packed_rows_budget(am, t.packed_row_len)
        try:
            return pack_code_batch(np.asarray(batch.input_ids), am,
                                   num_rows=self.pack_rows,
                                   row_len=t.packed_row_len)
        except ValueError as e:
            if "rows" in str(e):
                raise ValueError(f"{e}: raise TrainConfig.packed_rows_per_shard "
                                 f"(current {self.pack_rows})") from e
            raise

    def fit(self, state: TrainState, batches: Iterable[CodeBatch], *,
            max_steps: int | None = None) -> TrainState:
        """Train over host CodeBatches (numpy, as ``epoch_batches`` yields
        them) until they run out or ``state.step`` reaches ``max_steps``;
        with a workdir, checkpoint after every ``ckpt_every``-th step."""
        t = self.cfg.train
        log_t0, log_steps = time.perf_counter(), 0
        batches = iter(batches)
        while max_steps is None or state.step < max_steps:
            # checked before the next batch is drawn: none is collated idly
            batch = next(batches, None)
            if batch is None:
                break
            step = state.step
            packed = self.pack(batch).to(self.device) if t.packed_text else None
            state, metrics = self.step_fn(state, batch.to(self.device), packed)
            log_steps += 1
            if (step + 1) % t.log_every == 0:
                # one copy to the host for all the scalars
                values = torch.stack([v.float() for v in metrics.values()]).tolist()
                metrics = dict(zip(metrics, values))
                metrics["steps_per_sec"] = log_steps / max(time.perf_counter() - log_t0, 1e-9)
                if self.log_fn is not None:
                    self.log_fn(step + 1, metrics)
                log_t0, log_steps = time.perf_counter(), 0
            if self.ckpt is not None and (step + 1) % t.ckpt_every == 0:
                self.save(state)
        return state

