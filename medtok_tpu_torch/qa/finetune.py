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

One device only: ``mesh_dp`` / ``mesh_tp`` above 1 raise (tensor-parallel
8B finetuning waits for a four-card cell).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.qa.llama import LlamaConfig, LlamaModel, init_llama_
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
    # kept for the JAX config's shape; above 1 raises
    mesh_dp: int = 1
    mesh_tp: int = 1


def is_trainable(name: str) -> bool:
    """LoRA adapters and the soft-prompt projector (by parameter name)."""
    return any(part in ("lora_a", "lora_b", "projector") for part in name.split("."))


class QAFinetuner:
    """The soft prompt and the LoRA LLM on one device (CUDA unless
    ``device`` names another; without a GPU ``device=None`` raises). The
    base weights are in ``dtype`` (bf16 for the 8B layout), the trainable
    tensors in fp32."""

    def __init__(self, llm_cfg: LlamaConfig, embeddings: np.ndarray,
                 cfg: QAFinetuneConfig = QAFinetuneConfig(), *, device=None,
                 dtype=torch.float32):
        if cfg.mesh_dp > 1 or cfg.mesh_tp > 1:
            raise NotImplementedError(
                f"mesh_dp={cfg.mesh_dp}, mesh_tp={cfg.mesh_tp}: QA finetuning runs on one "
                "device (tensor-parallel 8B finetuning is not ported)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.llm_cfg = dataclasses.replace(
            llm_cfg, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
            lora_targets=cfg.lora_targets,
        )
        self.model = LlamaModel(self.llm_cfg, dtype=dtype, device=self.device)
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
        it lacks, such as the LoRA adapters, keeps its fresh value."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        init_llama_(self.model, generator)
        w = self.soft_prompt.projector.weight
        w.normal_(0.0, float(w.shape[1]) ** -0.5, generator=generator)
        self.soft_prompt.projector.bias.zero_()
        if llm_params is not None:
            unexpected = self.model.load_state_dict(llm_params, strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"no LlamaModel parameter for {unexpected}")

    def loss_fn(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """Masked mean token cross-entropy in fp32 over the label window:
        the LM head runs on hidden[:, cutoff_len - 1 : -1] only (every label
        that is not -100 lies at a position >= cutoff_len after the
        right-aligned packing)."""
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
        ll = F.cross_entropy(logits.flatten(0, 1), labels.clamp(min=0).flatten(),
                             reduction="none").view(labels.shape)
        return (ll * valid).sum() / valid.sum().clamp(min=1)

    def train_step(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """One AdamW step on a collated batch; returns the loss (detached,
        on the device)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def fit(self, rows: list[dict], *,
            log_fn: Callable[[int, float], None] | None = None) -> None:
        """``cfg.epochs`` passes over ``rows`` in the order of
        ``np.random.default_rng(cfg.seed).permutation`` (one draw per
        epoch), in batches of ``cfg.batch_size`` (the last partial batch
        dropped), from a fresh AdamW state."""
        cfg = self.cfg
        self.optimizer = self.make_optimizer()
        rng = np.random.default_rng(cfg.seed)
        step = 0
        for _ in range(cfg.epochs):
            order = rng.permutation(len(rows))
            for start in range(0, len(rows) - cfg.batch_size + 1, cfg.batch_size):
                batch = _collate_rows([rows[i] for i in order[start:start + cfg.batch_size]],
                                      cutoff_len=cfg.cutoff_len)
                loss = self.train_step(batch)
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
