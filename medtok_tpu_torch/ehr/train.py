"""EHR training: weighted sampling, the Adam loop, metrics and early stop
(counterpart of ``medtok_tpu/ehr/train.py``).

Class-balancing weighted sampling with replacement, CE for lenofstay and
BCE-with-logits otherwise, AUROC / AUPRC / F1 (micro / weighted at 0.2 for
the multi-label tasks, binary at 0.5 otherwise), Adam with the per-epoch
periodic cosine learning rate (T_max 10, eta_min 1e-3), early stop on the
validation AUPRC. The metrics are numpy (the GPU machine has no sklearn);
they follow sklearn's definitions (average precision as the step sum, not
the trapezoid).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.ehr.dataset import EHRBatch, EHRFeaturizer, make_label_vec
from medtok_tpu_torch.ehr.model import EHRModel, to_device
from medtok_tpu_torch.models.layers import init_random_, resolve_use_flash

MULTI_TASKS = ("lenofstay", "phenotype", "drugrec")
ETA_MIN = 1e-3
T_MAX = 10.0


# ------------------------------------------------------------- metrics -----

def _clf_curve(y: np.ndarray, score: np.ndarray):
    """(false positives, true positives) at each distinct score, highest
    score first (sklearn's ``_binary_clf_curve``)."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(score)), y.size - 1]
    tps = np.cumsum(y)[last]
    return 1 + last - tps, tps


def roc_auc(y, score) -> float:
    """Area under the ROC curve (trapezoid over the distinct thresholds)."""
    fps, tps = _clf_curve(np.asarray(y, np.float64), np.asarray(score, np.float64))
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def average_precision(y, score) -> float:
    """sum_n (R_n - R_{n-1}) P_n over the distinct thresholds."""
    fps, tps = _clf_curve(np.asarray(y, np.float64), np.asarray(score, np.float64))
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _f1_counts(y, pred):
    tp = float(np.sum((y == 1) & (pred == 1)))
    fp = float(np.sum((y == 0) & (pred == 1)))
    fn = float(np.sum((y == 1) & (pred == 0)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def compute_metrics(task: str, num_class: int, label_raw, probs) -> dict:
    """probs: softmax for lenofstay/readmission/mortality, sigmoid
    otherwise."""
    probs = np.asarray(probs, np.float64)
    label_raw = np.asarray(label_raw)
    if task in MULTI_TASKS:
        if label_raw.ndim == 1:
            onehot = np.zeros((label_raw.size, num_class))
            onehot[np.arange(label_raw.size), label_raw.astype(int)] = 1
        else:
            onehot = label_raw
        onehot = onehot.astype(int)
        auroc = roc_auc(onehot.ravel(), probs.ravel())
        aupr = average_precision(onehot.ravel(), probs.ravel())
        pred = (probs >= 0.2).astype(int)
        support = onehot.sum(axis=0)
        f1s = np.array([_f1_counts(onehot[:, c], pred[:, c])
                        for c in range(onehot.shape[1])])
        f1 = float(np.sum(f1s * support) / support.sum()) if support.sum() else 0.0
    else:
        p1 = probs[:, 1]
        auroc = roc_auc(label_raw, p1)
        aupr = average_precision(label_raw, p1)
        f1 = _f1_counts(label_raw.astype(int), (p1 > 0.5).astype(int))
    return {"auc": float(auroc), "aupr": float(aupr), "f1": float(f1)}


def task_probs(task: str, logits: torch.Tensor) -> torch.Tensor:
    if task in ("lenofstay", "readmission", "mortality"):
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def task_loss(task: str, logits: torch.Tensor, label_onehot: torch.Tensor) -> torch.Tensor:
    if task == "lenofstay":
        return -(label_onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.binary_cross_entropy_with_logits(logits, label_onehot)


# ------------------------------------------------------------ sampling -----

def sample_weights(labels: np.ndarray, task: str) -> np.ndarray:
    """Inverse-class-frequency weights."""
    if task in ("phenotype", "drugrec"):
        return np.ones(len(labels))
    counts = np.bincount(labels.astype(int))
    return (1.0 / counts)[labels.astype(int)]


def weighted_batches(feats: list[dict], weights: np.ndarray,
                     featurizer: EHRFeaturizer, *, batch_size: int,
                     rng: np.random.Generator) -> Iterator[EHRBatch]:
    """One epoch of weighted sampling with replacement (the JAX package's
    numpy draws)."""
    n = len(feats)
    p = weights / weights.sum()
    order = rng.choice(n, size=n, replace=True, p=p)
    for start in range(0, n - batch_size + 1, batch_size):
        yield featurizer.collate([feats[i] for i in order[start:start + batch_size]])


# ---------------------------------------------------------------- loop ------

@dataclasses.dataclass
class EHRTrainConfig:
    task: str = "readmission"
    batch_size: int = 256
    epochs: int = 100
    lr: float = 1e-3
    num_layers: int = 4
    dropout: float = 0.5
    hidden_dim: int = 256
    input_dim: int = 64
    output_dim: int = 64
    num_heads: int = 4
    max_visits: int = 100
    max_medical_code: int = 2000
    early_stop_patience: int = 5
    seed: int = 42
    # flash attention (K3) in the encoder: True / False / "auto" (K3 on a
    # CUDA device, the dense path on the CPU: models/layers.py::
    # resolve_use_flash)
    flash_attention: bool | str = "auto"
    # "default": fp32 q/k/v enter K3 in bf16; "highest" keeps fp32
    flash_precision: str = "default"
    pe_dropout: float = 0.2


class EHRTrainer:
    """Trains an ``EHRModel`` on one device: CUDA unless ``device`` names
    another (without a GPU, ``device=None`` raises). Parameters start from
    ``init_random_`` with a CPU generator seeded by ``cfg.seed``, so every
    device starts from the same weights; dropout draws from a generator on
    the device seeded by ``cfg.seed + 2``."""

    def __init__(self, cfg: EHRTrainConfig, embedding_table: np.ndarray,
                 num_class: int, *, device=None):
        self.cfg = cfg
        self.num_class = num_class
        self.device = resolve_device(device)
        self.use_flash = resolve_use_flash(cfg.flash_attention, self.device)
        self.model = EHRModel(
            embedding_table, num_class, input_dim=cfg.input_dim,
            output_dim=cfg.output_dim, num_heads=cfg.num_heads,
            hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
            dropout=cfg.dropout, use_flash=self.use_flash,
            flash_precision=cfg.flash_precision, pe_dropout=cfg.pe_dropout,
        )
        self.reset(steps_per_epoch=1)

    def reset(self, steps_per_epoch: int) -> None:
        """Fresh weights, optimizer state, step count and dropout
        generator."""
        cfg = self.cfg
        init_random_(self.model.cpu(), torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 2)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.step = 0

    def lr_at(self, epoch: int) -> float:
        """torch CosineAnnealingLR(T_max=10, eta_min=1e-3) in closed form,
        stepped per epoch: periodic, it rises again after T_max."""
        cfg = self.cfg
        return ETA_MIN + (cfg.lr - ETA_MIN) * 0.5 * (1.0 + math.cos(math.pi * epoch / T_MAX))

    def train_step(self, batch: EHRBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on a numpy batch; (loss, probs) on the device."""
        self.model.train()
        b = to_device(batch, self.device)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step // self.steps_per_epoch)
        self.optimizer.zero_grad(set_to_none=True)
        _, logits = self.model(b, generator=self.generator)
        loss = task_loss(self.cfg.task, logits, b.label_onehot)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach(), task_probs(self.cfg.task, logits.detach())

    @torch.no_grad()
    def eval_step(self, batch: EHRBatch) -> torch.Tensor:
        self.model.eval()
        _, logits = self.model(to_device(batch, self.device))
        return task_probs(self.cfg.task, logits)

    def evaluate(self, batches: list[EHRBatch]) -> dict:
        probs = [self.eval_step(b).cpu().numpy() for b in batches]
        raws = [np.asarray(b.label_raw) for b in batches]
        return compute_metrics(self.cfg.task, self.num_class,
                               np.concatenate(raws), np.concatenate(probs))

    def fit(self, feats_train: list[dict], weights_train: np.ndarray,
            val_batches: list[EHRBatch], featurizer: EHRFeaturizer, *,
            log_fn: Callable[[int, dict], None] | None = None):
        """Train from fresh weights; returns (the state_dict of the best
        validation AUPRC, its metrics). The model keeps the last weights."""
        cfg = self.cfg
        rng_np = np.random.default_rng(cfg.seed)
        self.reset(steps_per_epoch=len(feats_train) // cfg.batch_size)
        best = {"aupr": -1.0}
        best_state = self._state()
        patience = 0
        loss = torch.tensor(float("nan"))  # no train batch yet (tiny datasets)
        for epoch in range(cfg.epochs):
            for batch in weighted_batches(feats_train, weights_train, featurizer,
                                          batch_size=cfg.batch_size, rng=rng_np):
                loss, _ = self.train_step(batch)
            metrics = self.evaluate(val_batches)
            if log_fn:
                log_fn(epoch, {"val": metrics, "loss": float(loss)})
            if metrics["aupr"] > best["aupr"]:
                best, best_state, patience = metrics, self._state(), 0
            else:
                patience += 1
                if patience >= cfg.early_stop_patience:
                    break
        return best_state, best

    def _state(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}


def prepare_task_features(dataset: list[list[dict]], labels: np.ndarray,
                          num_class: int, task: str, *, vocab_size: int,
                          max_visits: int = 100, max_medical_code: int = 2000,
                          ) -> tuple[list[dict], EHRFeaturizer]:
    """First-sample-per-patient featurization."""
    featurizer = EHRFeaturizer(vocab_size=vocab_size, max_visits=max_visits,
                               max_medical_code=max_medical_code)
    feats = []
    for i, d in enumerate(dataset):
        vec = make_label_vec(labels[i], num_class, task)
        feats.append(featurizer.featurize(d[0], vec, labels[i]))
    return feats, featurizer
