"""Tokenizer training on one device or data parallel over
``torch.distributed`` (counterpart of ``medtok_tpu/train/trainer.py``).

A step runs the training forward (``MultimodalTokenizer.forward_train``)
and ``train/losses.py::assemble_losses``, back-propagates, clips the
trainable gradients by their global norm and takes an Adam step, as optax's
``clip_by_global_norm`` + ``adam`` compute them, then updates the optional
parameter EMA. The trainable parameters are all but the frozen text
encoder's: it gets no gradient and no optimizer state (nor does the EMA
codebook of ``use_kmeans``, which is a buffer). The model holds fp32
parameters and computes in ``ModelConfig.compute_dtype``; the quantizer's
usage FIFO (and the EMA codebook) lives in its buffers and is written by
each step. ``kmeans_init_codebook`` sets the codebook from the first
batch's shared features before step 0 of a ``--kmeans`` run.

    trainer = Trainer(cfg, workdir="results/run")   # on CUDA
    state = trainer.init_state()      # resumes from the workdir's latest checkpoint
    state = trainer.fit(state, epoch_batches(dataset, batch_size=1024), max_steps=n)

With a ``workdir``, ``fit`` saves a checkpoint every ``ckpt_every`` steps
(``utils/checkpoint.py``, rotated to ``max_checkpoints``) and ``init_state``
restores the latest one; ``cli/train.py`` is the command line around it.

On a (dp, tp) mesh (``Trainer(..., dp=initialize_distributed(device,
tp=T))``, one process a GPU under torchrun, world = dp x tp): each dp block
trains on its block of every global batch (``epoch_batches(process_index=
dp_index, process_count=dp_size)``), its InfoNCE negatives its own, and the
tp ranks of a block split each codebook sweep's rows
(``ops.vq.distance_topk_tp``). After backward one flat all-reduce averages
the trainable gradients over the dp axis, another the metrics, before the
clip and Adam, so every rank takes the same step (the tp ranks of a block
already hold the same gradients); the quantizer's usage FIFO and EMA
codebook take the dp blocks' indices and statistics
(``models/quantizer.py``). Each dp block draws its own dropout masks from
``parallel.mesh.rank_seed(seed + 1, dp_index)``, the same on its tp ranks,
which must sweep the same rows (a restored rank takes its own generator
state from the checkpoint); the packed row budget is the largest rank's,
and rank 0 writes the checkpoints (with every rank's generator state) while
the others wait.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import load_params
from medtok_tpu_torch.data.packing import pack_code_batch
from medtok_tpu_torch.data.types import CodeBatch, PackedTextBatch
from medtok_tpu_torch.models.deepseek_v2 import count_routed
from medtok_tpu_torch.models.layers import init_random_
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.ops.ema import kmeans
from medtok_tpu_torch.parallel.mesh import DataParallel, check_mesh, rank_seed
from medtok_tpu_torch.train.losses import assemble_losses
from medtok_tpu_torch.utils.checkpoint import CheckpointManager
from medtok_tpu_torch.utils.profiling import count, span

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
    generator: torch.Generator      # the dropout masks (BERT's, the cross-attention's)


def create_train_state(cfg: MedTokConfig, model: MultimodalTokenizer, *,
                       params: Mapping | str | Path | None = None,
                       rank: int = 0) -> TrainState:
    """A fresh state on the model's device. Parameters are drawn by
    ``init_random_`` from a generator seeded by ``TrainConfig.global_seed``,
    or loaded from ``params``: a flax params tree, a variables dict with
    its ``usage`` collection, or a .npz of either (``convert.load_params``).
    Adam's state starts at zero, the EMA as a copy of the parameters, the
    dropout generator at ``rank_seed(seed + 1, rank)`` (the seed + 1 on
    one device; ``rank`` is the dp block's index on a mesh)."""
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
                      generator=torch.Generator(device=dev).manual_seed(
                          rank_seed(seed + 1, rank)))


@torch.no_grad()
def kmeans_init_codebook(model: MultimodalTokenizer, state: TrainState,
                         batches: Iterable[CodeBatch], *,
                         generator: torch.Generator | None = None,
                         init_idx: torch.Tensor | None = None,
                         dp: DataParallel | None = None) -> TrainState:
    """Cosine k-means (10 iterations) over the batches' ``encode_shared``
    rows (each batch's text rows, then its graph rows) into the codebook:
    under ``use_kmeans`` the EMA codebook and its cluster sizes (the final
    bins), otherwise the ``codebook`` parameter. The initial means are
    ``init_idx``, or drawn by ``ops.ema.kmeans`` from ``generator`` (a CPU
    generator, default seed 0). On a mesh, ``batches`` are each dp block's
    and the rows clustered are the global batch's (the blocks' text rows in
    order, then their graph rows, gathered over the dp axis), clustered on
    rank 0 and broadcast to the world, so every rank holds the same
    codebook. Returns ``state``."""
    dev = next(model.parameters()).device
    feats = []
    for b in batches:
        rows = model.encode_shared(b.to(dev))
        feats += [r if dp is None else dp.all_gather(r, axis="dp") for r in rows]
    q = model.quantize
    C, D = q.cfg.codebook_size, q.cfg.codebook_embed_dim
    if dp is None or dp.rank == 0:
        means, bins = kmeans(torch.cat(feats), C, num_iters=10, use_cosine_sim=True,
                             generator=generator, init_idx=init_idx)
    else:
        means = torch.empty((C, D), dtype=torch.float32, device=dev)
        bins = torch.empty(C, dtype=torch.float32, device=dev)
    if dp is not None:
        means, bins = means.float().contiguous(), bins.float().contiguous()
        dp.broadcast_([means, bins])
    if q.cfg.use_kmeans:
        q.ema_codebook = means.to(q.ema_codebook.dtype)
        q.ema_cluster = bins.to(q.ema_cluster.dtype)
    else:
        q.codebook.copy_(means)
    return state


def _loss_fn(model: MultimodalTokenizer, batch: CodeBatch, cfg: MedTokConfig, *,
             packed: PackedTextBatch | None = None,
             generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total loss, metrics) of the training forward; writes the usage
    FIFO (and the EMA codebook)."""
    out = model.forward_train(batch, packed=packed, generator=generator)
    with span("train.losses"):
        breakdown = assemble_losses(
            out, shared_loss_beta=cfg.train.shared_loss_beta,
            specific_loss_lamb=cfg.train.specific_loss_lamb,
            entropy_loss_ratio=cfg.model.quantizer.entropy_loss_ratio,
        )
    return breakdown.total, breakdown.metrics


def make_train_step(cfg: MedTokConfig, model: MultimodalTokenizer,
                    dp: DataParallel | None = None
                    ) -> Callable[..., tuple[TrainState, dict]]:
    """The step ``(state, batch, packed=None) -> (state, metrics)`` on
    device tensors: forward, backward, clip + Adam, EMA. The state is
    updated in place and returned; the metrics are detached device
    scalars. With ``dp`` (the model built with the same) the trainable
    gradients, then the metrics, are averaged over the dp axis by one flat
    all-reduce each after backward (``train.allreduce``). The ``train.*``
    ranges (here, in ``_loss_fn`` and in the model) name the step's parts
    in a torch.profiler trace."""
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
        with span("train.backward"):
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp is not None:
            with span("train.allreduce"):
                dp.all_reduce_mean_([p.grad for p in params], axis="dp")
                values = torch.stack([v.float() for v in metrics.values()])
                dp.all_reduce_mean_([values], axis="dp")
                metrics = dict(zip(metrics, values.unbind()))
        with span("train.optimizer"):
            tx.step(params, [p.grad for p in params], state.opt_state)
            if state.ema_params is not None:
                with torch.no_grad():
                    torch._foreach_mul_(state.ema_params, decay)
                    torch._foreach_add_(state.ema_params, params, alpha=1.0 - decay)
        state.step += 1
        return state, metrics

    return step_fn


def packed_rows_budget(attention_mask: np.ndarray, row_len: int,
                       dp: DataParallel | None = None) -> int:
    """The automatic row budget of the packed text path: 1.3 times the
    rows the batch's tokens fill, at least 2; data parallel, the largest
    of the ranks' budgets (the JAX trainer's multi-process rule)."""
    est = max(2, int(np.ceil(1.3 * attention_mask.sum() / row_len)))
    return est if dp is None else dp.all_reduce_max(est)


class Trainer:
    """Host loop on one device (CUDA unless ``device`` names another;
    without a GPU ``device=None`` raises), or on this rank's device of a
    (dp, tp) mesh ``dp`` (``parallel.mesh.initialize_distributed``; its tp
    axis ``mesh_tp``, its dp axis ``mesh_dp`` or -1): packs each batch's texts when
    ``TrainConfig.packed_text`` is set, runs the step, every ``log_every``
    steps passes the metrics as floats with ``steps_per_sec`` to
    ``log_fn(step, metrics)``, and with a ``workdir`` saves a checkpoint
    every ``ckpt_every`` steps (``args.json`` written there once; rank 0
    writes, every rank takes part). Without ``dp`` a ``mesh_dp`` or
    ``mesh_tp`` above 1 raises, naming the torchrun launch it needs."""

    def __init__(self, cfg: MedTokConfig, *, device=None, workdir: str | Path | None = None,
                 log_fn: Callable[[int, dict], None] | None = None,
                 dp: DataParallel | None = None):
        t = cfg.train
        check_mesh(t.mesh_dp, t.mesh_tp, 1 if dp is None else dp.world)
        if dp is not None and dp.tp_size != t.mesh_tp:
            raise ValueError(f"mesh_tp={t.mesh_tp} but the mesh's tp axis is {dp.tp_size}: "
                             f"pass initialize_distributed(device, tp={t.mesh_tp})")
        self.cfg = cfg
        self.dp = dp
        self.rank = 0 if dp is None else dp.rank
        self.device = resolve_device(device)
        self.model = MultimodalTokenizer(cfg.model, param_dtype=torch.float32,
                                         device=self.device, dp=dp)
        self.log_fn = log_fn
        self.step_fn = make_train_step(cfg, self.model, dp)
        self.pack_rows = t.packed_rows_per_shard
        self.ckpt = None
        if workdir is not None:
            self.ckpt = CheckpointManager(workdir, max_to_keep=t.max_checkpoints,
                                          config=cfg if self.rank == 0 else None)

    def init_state(self, params: Mapping | str | Path | None = None) -> TrainState:
        """A fresh state (random parameters from ``TrainConfig.global_seed``,
        or ``params`` as ``create_train_state`` takes them), then, when the
        workdir holds a checkpoint, the latest one restored into it (on every
        rank: each takes its own generator state)."""
        block = 0 if self.dp is None else self.dp.dp_index
        state = create_train_state(self.cfg, self.model, params=params, rank=block)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            ck = self.ckpt.load(map_location=next(self.model.parameters()).device)
            state, self.pack_rows = self.ckpt.restore(state, payload=ck)
            gens = ck.get("generators")
            if self.rank and gens is not None and len(gens) == self.dp.world:
                state.generator.set_state(gens[self.rank].cpu())
            elif block:     # saved by another world size: decorrelate by block and step
                state.generator.manual_seed(rank_seed(
                    state.generator.initial_seed() + state.step, block))
            # (the file's own generator is rank 0's, and so block 0's)
        return state

    def save(self, state: TrainState) -> Path | None:
        """Checkpoint ``state`` into the workdir (None without one). Data
        parallel, every rank calls it: rank 0 writes (above one rank, every
        rank's generator state in the file), the others wait for the write."""
        if self.ckpt is None:
            return None
        if self.dp is None:
            return self.ckpt.save(state, pack_rows=self.pack_rows)
        gens = (self.dp.all_gather_object(state.generator.get_state())
                if self.dp.world > 1 else None)
        if self.rank == 0:
            self.ckpt.save(state, pack_rows=self.pack_rows, generators=gens)
        self.dp.barrier()
        return self.ckpt.path(state.step)

    def pack(self, batch: CodeBatch) -> PackedTextBatch:
        """The batch's texts packed into the row budget (numpy); the budget
        of ``packed_rows_per_shard`` = 0 is fixed from the first batch."""
        t = self.cfg.train
        am = np.asarray(batch.attention_mask)
        if self.pack_rows == 0:
            self.pack_rows = packed_rows_budget(am, t.packed_row_len, self.dp)
        try:
            packed = pack_code_batch(np.asarray(batch.input_ids), am,
                                     num_rows=self.pack_rows,
                                     row_len=t.packed_row_len)
        except ValueError as e:
            if "rows" in str(e):
                raise ValueError(f"{e}: raise TrainConfig.packed_rows_per_shard "
                                 f"(current {self.pack_rows})") from e
            raise
        count("text.tokens", int(np.count_nonzero(packed.text_mask)))
        count("text.slots", packed.input_ids.size)
        count_routed(self.cfg.model.text, np.count_nonzero(packed.text_mask),
                     packed.input_ids.size)
        return packed

    def fit(self, state: TrainState, batches: Iterable[CodeBatch], *,
            max_steps: int | None = None) -> TrainState:
        """Train over host CodeBatches (numpy, as ``epoch_batches`` yields
        them; data parallel, this rank's blocks) until they run out or
        ``state.step`` reaches ``max_steps``; with a workdir, checkpoint
        after every ``ckpt_every``-th step. Each host phase of a step runs in
        its own ``train.*`` range (``utils/profiling.py::span``): ``draw``
        (the iterator's batch build), ``pack``, ``to_device`` (the copies),
        ``metrics`` (their one copy to the host, which waits for the step,
        and ``log_fn``) and ``checkpoint``; none encloses the step's own."""
        t = self.cfg.train
        log_t0, log_steps = time.perf_counter(), 0
        batches = iter(batches)
        while max_steps is None or state.step < max_steps:
            # checked before the next batch is drawn: none is collated idly
            with span("train.draw"):
                batch = next(batches, None)
            if batch is None:
                break
            step = state.step
            with span("train.pack"):
                packed = self.pack(batch) if t.packed_text else None
                if packed is None:
                    am = np.asarray(batch.attention_mask)
                    count_routed(self.cfg.model.text, np.count_nonzero(am), am.size)
            with span("train.to_device"):
                packed = packed.to(self.device) if packed is not None else None
                batch = batch.to(self.device)
            state, metrics = self.step_fn(state, batch, packed)
            log_steps += 1
            if (step + 1) % t.log_every == 0:
                with span("train.metrics"):
                    # one copy to the host for all the scalars
                    values = torch.stack([v.float() for v in metrics.values()]).tolist()
                    metrics = dict(zip(metrics, values))
                    metrics["steps_per_sec"] = log_steps / max(time.perf_counter() - log_t0,
                                                               1e-9)
                    if self.log_fn is not None:
                        self.log_fn(step + 1, metrics)
                    log_t0, log_steps = time.perf_counter(), 0
            if self.ckpt is not None and (step + 1) % t.ckpt_every == 0:
                with span("train.checkpoint"):
                    self.save(state)
        return state

