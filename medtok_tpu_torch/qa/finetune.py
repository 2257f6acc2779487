"""LoRA finetuning of the soft-prompted LLM on MedTok QA rows (counterpart
of ``medtok_tpu/qa/finetune.py``).

LoRA (r=16, alpha=32 on q_proj / v_proj) and the soft-prompt projector are
the only parameters with ``requires_grad``: the frozen base gets no
gradient and no optimizer state, though the backward pass runs through it
to reach the adapters of earlier layers and the projector. The optimizer is
``optax.adamw(lr)``'s: b1 0.9, b2 0.999, eps 1e-8 and decoupled weight decay
1e-4 on every trainable tensor. Rows are ``{"input": [q, a],
"medical_codes": [...]}`` packed by ``qa.prompting.pack_example``.

    ft = QAFinetuner(TINY_LLAMA, embeddings, QAFinetuneConfig(), device="cpu")
    ft.init_params(llm_state_dict)   # random weights, loaded ones laid over
    ft.fit(rows, log_fn=lambda step, loss: ...)

On a (dp, tp) mesh (``QAFinetuner(..., dp=initialize_distributed(device,
dp=D, tp=T))`` under ``torchrun --nproc-per-node D*T``): the tp ranks split
the LLM (``qa/sharding.py``, ``qa/llama.py``), and the dp blocks split each
global batch, which is collated whole first (so every block has its
shapes) and then cut into D blocks of rows. The loss stays one mean over
the global batch's valid labels: each rank divides its sum by the count
summed over dp, and the trainable gradients are summed over dp. The LM
head's logits stay split over tp through the loss. Without a mesh,
``mesh_dp`` / ``mesh_tp`` above 1 raise, naming the torchrun launch they
need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.parallel.mesh import check_mesh
from medtok_tpu_torch.qa import sharding
from medtok_tpu_torch.qa.llama import LlamaConfig, LlamaModel, init_llama_, reduce_from_tp
from medtok_tpu_torch.qa.softprompt import MedTokSoftPrompt

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default (torch.optim.AdamW's is 1e-2)


@dataclasses.dataclass
class QAFinetuneConfig:
    lora_rank: int = 16
    lora_alpha: float = 32.0
    lora_targets: tuple[str, ...] = ("q_proj", "v_proj")
    cutoff_len: int = 256
    total_len: int = 512
    lr: float = 3e-4
    batch_size: int = 16
    epochs: int = 1
    seed: int = 0
    # the (dp, tp) mesh: dp blocks split the batch, tp ranks the LLM (dp -1:
    # world / tp); above 1 needs QAFinetuner(dp=) under torchrun
    mesh_dp: int = 1
    mesh_tp: int = 1


def is_trainable(name: str) -> bool:
    """LoRA adapters and the soft-prompt projector (by parameter name)."""
    return any(part in ("lora_a", "lora_b", "projector") for part in name.split("."))


class QAFinetuner:
    """The soft prompt and the LoRA LLM on one device (CUDA unless
    ``device`` names another; without a GPU ``device=None`` raises), or on
    this rank's device of a (dp, tp) mesh ``dp`` (its axes ``cfg.mesh_dp``
    or -1 and ``cfg.mesh_tp``). The base weights are in ``dtype`` (bf16 for
    the 8B layout), the trainable tensors in fp32."""

    def __init__(self, llm_cfg: LlamaConfig, embeddings: np.ndarray,
                 cfg: QAFinetuneConfig = QAFinetuneConfig(), *, device=None,
                 dtype=torch.float32, dp=None):
        check_mesh(cfg.mesh_dp, cfg.mesh_tp, 1 if dp is None else dp.world)
        if dp is not None and dp.tp_size != cfg.mesh_tp:
            raise ValueError(f"mesh_tp={cfg.mesh_tp} but the mesh's tp axis is {dp.tp_size}")
        if dp is not None and cfg.batch_size % dp.dp_size:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by the "
                             f"{dp.dp_size} data-parallel blocks")
        self.cfg = cfg
        self.mesh = dp
        self.device = resolve_device(device) if dp is None else dp.device
        self.llm_cfg = dataclasses.replace(
            llm_cfg, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
            lora_targets=cfg.lora_targets,
        )
        self.model = LlamaModel(self.llm_cfg, dtype=dtype, device=self.device, mesh=dp)
        self.soft_prompt = MedTokSoftPrompt(embeddings, self.llm_cfg.hidden_size,
                                            cfg.cutoff_len, device=self.device)
        for name, p in self.named_parameters():
            p.requires_grad_(is_trainable(name))
        self.optimizer = self.make_optimizer()

    def named_parameters(self):
        """("llm." / "soft_prompt." + name, parameter) of both modules."""
        for prefix, module in (("llm", self.model), ("soft_prompt", self.soft_prompt)):
            for name, p in module.named_parameters():
                yield f"{prefix}.{name}", p

    def trainable_parameters(self) -> list[torch.Tensor]:
        return [p for _, p in self.named_parameters() if p.requires_grad]

    def make_optimizer(self) -> torch.optim.AdamW:
        return torch.optim.AdamW(self.trainable_parameters(), lr=self.cfg.lr,
                                 betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                 weight_decay=ADAMW_WEIGHT_DECAY)

    @torch.no_grad()
    def init_params(self, llm_params: Mapping[str, torch.Tensor] | None = None,
                    generator: torch.Generator | None = None) -> None:
        """Random weights for both modules from ``generator`` (seeded by
        ``cfg.seed`` by default), then ``llm_params`` (a state_dict of
        ``LlamaModel``, e.g. ``convert_hf_llama``'s) laid over the LLM: what
        it lacks, such as the LoRA adapters, keeps its fresh value. On a tp
        mesh both are the one-device model's, each rank keeping its
        slices."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        init_llama_(self.model, generator)
        w = self.soft_prompt.projector.weight
        w.normal_(0.0, float(w.shape[1]) ** -0.5, generator=generator)
        self.soft_prompt.projector.bias.zero_()
        if llm_params is not None:
            if self.model.mesh is not None:
                llm_params = sharding.shard_state_dict(llm_params, self.llm_cfg,
                                                       self.mesh.tp_size, self.mesh.tp_index)
            unexpected = self.model.load_state_dict(llm_params, strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"no LlamaModel parameter for {unexpected}")

    def _loss_sum(self, batch: Mapping[str, np.ndarray]) -> tuple[torch.Tensor, torch.Tensor]:
        """(sum of the token cross-entropies in fp32, count of valid labels)
        over the label window: the LM head runs on hidden[:, cutoff_len - 1
        : -1] only (every label that is not -100 lies at a position >=
        cutoff_len after the right-aligned packing). On a tp mesh the
        logits stay split over the vocabulary: the max, the sum of exps and
        the label's logit are reduced over tp."""
        ids, mask, labels = (torch.as_tensor(np.asarray(batch[k]), dtype=torch.long,
                                             device=self.device)
                             for k in ("input_ids", "attention_mask", "labels"))
        packed = self.soft_prompt(ids, mask, labels, self.model.embed, self.cfg.total_len)
        hidden, _ = self.model(inputs_embeds=packed.inputs_embeds,
                               attention_mask=packed.attention_mask, return_hidden=True)
        cl = self.cfg.cutoff_len
        logits = self.model.apply_lm_head(hidden[:, cl - 1:-1]).float()
        labels = packed.labels[:, cl:]
        valid = labels != -100
        safe = labels.clamp(min=0)
        mesh = self.model.mesh
        if mesh is None:
            ll = F.cross_entropy(logits.flatten(0, 1), safe.flatten(),
                                 reduction="none").view(labels.shape)
        else:
            top = mesh.all_reduce_(logits.detach().amax(dim=-1, keepdim=True), "tp", "max")
            sum_exp = reduce_from_tp(torch.exp(logits - top).sum(dim=-1), mesh)
            local = safe - self.model.vocab_start
            mine = (local >= 0) & (local < self.model.vocab_local)
            picked = torch.gather(logits, -1, local.clamp(0, self.model.vocab_local - 1)
                                  [..., None])[..., 0]
            label_logit = reduce_from_tp(torch.where(mine, picked, 0.0), mesh)
            ll = torch.log(sum_exp) + top[..., 0] - label_logit
        return (ll * valid).sum(), valid.sum()

    def loss_fn(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """Masked mean token cross-entropy in fp32 over the label window.
        On a mesh ``batch`` is this rank's dp block of the global batch and
        the result its share of the global mean: its sum over the valid
        labels counted over all dp blocks (so the shares sum to the mean)."""
        total, count = self._loss_sum(batch)
        if self.mesh is not None:
            self.mesh.all_reduce_(count, "dp")
        return total / count.clamp(min=1)

    def train_step(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """One AdamW step on a collated batch (on a mesh, this rank's dp
        block); returns the loss of the whole batch (detached, on the
        device)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch)
        loss.backward()
        if self.mesh is not None:
            sharding.reduce_shared_kv_grads_(self.model, self.mesh)
            grads = [p.grad for p in self.trainable_parameters()]
            self.mesh.all_reduce_sum_(grads, axis="dp")
            loss = self.mesh.all_reduce_(loss.detach().clone(), "dp")
        self.optimizer.step()
        return loss.detach()

    def local_block(self, batch: dict) -> dict:
        """This rank's dp block of the rows of a collated global batch (the
        batch itself without a mesh)."""
        if self.mesh is None or self.mesh.dp_size == 1:
            return batch
        n = self.cfg.batch_size // self.mesh.dp_size
        i = self.mesh.dp_index
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}

    def fit(self, rows: list[dict], *,
            log_fn: Callable[[int, float], None] | None = None) -> None:
        """``cfg.epochs`` passes over ``rows`` in the order of
        ``np.random.default_rng(cfg.seed).permutation`` (one draw per
        epoch), in batches of ``cfg.batch_size`` (the last partial batch
        dropped), from a fresh AdamW state; on a mesh each rank steps on its
        dp block of every batch."""
        cfg = self.cfg
        self.optimizer = self.make_optimizer()
        rng = np.random.default_rng(cfg.seed)
        step = 0
        for _ in range(cfg.epochs):
            order = rng.permutation(len(rows))
            for start in range(0, len(rows) - cfg.batch_size + 1, cfg.batch_size):
                batch = _collate_rows([rows[i] for i in order[start:start + cfg.batch_size]],
                                      cutoff_len=cfg.cutoff_len)
                loss = self.train_step(self.local_block(batch))
                step += 1
                if log_fn:
                    log_fn(step, float(loss))


def _collate_rows(rows: list[dict], *, cutoff_len: int) -> dict:
    """Pad packed rows to a common length (text part right-padded; labels
    -100-padded)."""
    tmax = max(len(r["input_ids"]) - cutoff_len for r in rows)
    B = len(rows)
    input_ids = np.zeros((B, cutoff_len + tmax), np.int32)
    attn = np.zeros((B, cutoff_len + tmax), np.int32)
    labels = np.full((B, tmax), -100, np.int32)
    for i, r in enumerate(rows):
        n = len(r["input_ids"]) - cutoff_len
        input_ids[i, :cutoff_len] = r["input_ids"][:cutoff_len]
        input_ids[i, cutoff_len:cutoff_len + n] = r["input_ids"][cutoff_len:]
        attn[i, :cutoff_len] = r["attention_mask"][:cutoff_len]
        attn[i, cutoff_len:cutoff_len + n] = r["attention_mask"][cutoff_len:]
        labels[i, :len(r["labels"])] = r["labels"]
    return {"input_ids": input_ids, "attention_mask": attn, "labels": labels}
