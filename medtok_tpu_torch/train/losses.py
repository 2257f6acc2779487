"""The tokenizer's training objective (counterpart of
``medtok_tpu/train/losses.py``): InfoNCE, alignment and orthogonality
losses, the optional codebook-entropy term, and their assembly into the
total loss with the 22-scalar metrics dict.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from medtok_tpu_torch.ops.vq import l2_normalize

NEG_INF = -1e9


def info_nce_loss(q: torch.Tensor, k: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE with in-batch negatives: the positive of row i is q_i.k_i,
    its negatives q_i.k_j for j != i. The diagonal of the similarity
    matrix is masked to -1e9 (a cross-entropy over [pos, negatives])."""
    n = q.shape[0]
    q = l2_normalize(q.float())
    k = l2_normalize(k.float())
    pos = (q * k).sum(dim=-1) / temperature                       # [N]
    sim = (q @ k.T) / temperature                                 # [N, N]
    eye = torch.eye(n, dtype=torch.bool, device=q.device)
    neg = torch.where(eye, NEG_INF, sim)
    logits = torch.cat([pos[:, None], neg], dim=-1)               # [N, N+1]
    return (torch.logsumexp(logits, dim=-1) - pos).mean()


def alignment_loss(mu1: torch.Tensor, mu2: torch.Tensor) -> torch.Tensor:
    """E[mu1 . mu2]."""
    return (mu1.float() * mu2.float()).sum(dim=1).mean()


def orthogonal_loss(z: torch.Tensor, z_star: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of z^T z_star."""
    m = z.float().T @ z_star.float()
    return torch.sqrt((m * m).sum())


def shared_loss(z1, z2, x1, x2):
    """(nce(z1, z2), align(x1n, x2n), nce(z2, z1), align(x2n, x1n))."""
    x1n = l2_normalize(x1.float())
    x2n = l2_normalize(x2.float())
    return (info_nce_loss(z1, z2), alignment_loss(x1n, x2n),
            info_nce_loss(z2, z1), alignment_loss(x2n, x1n))


def specific_loss(z1, z1_aug, z2, z2_aug, z1_c, z2_c):
    """(nce(z1^, z1_aug^), orth(z1, z1_c), nce(z2^, z2_aug^), orth(z2, z2_c))
    with z^ = cat(z, the other modality's shared embedding)."""
    z1, z1_aug, z2, z2_aug, z1_c, z2_c = (
        t.float() for t in (z1, z1_aug, z2, z2_aug, z1_c, z2_c))
    z1_hat = torch.cat([z1, z2_c], dim=-1)
    z1_aug_hat = torch.cat([z1_aug, z2_c], dim=-1)
    z2_hat = torch.cat([z2, z1_c], dim=-1)
    z2_aug_hat = torch.cat([z2_aug, z1_c], dim=-1)
    return (info_nce_loss(z1_hat, z1_aug_hat), orthogonal_loss(z1, z1_c),
            info_nce_loss(z2_hat, z2_aug_hat), orthogonal_loss(z2, z2_c))


def compute_entropy_loss(affinity: torch.Tensor,
                         temperature: float = 0.01) -> torch.Tensor:
    """Codebook-entropy regularizer: sample entropy minus the entropy of the
    average assignment (off unless ``entropy_loss_ratio`` > 0)."""
    flat = affinity.reshape(-1, affinity.shape[-1]).float() / temperature
    probs = torch.softmax(flat, dim=-1)
    log_probs = torch.log_softmax(flat + 1e-5, dim=-1)
    avg_probs = probs.mean(dim=0)
    avg_entropy = -(avg_probs * torch.log(avg_probs + 1e-5)).sum()
    sample_entropy = -(probs * log_probs).sum(dim=-1).mean()
    return sample_entropy - avg_entropy


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    metrics: dict


def assemble_losses(quantized_result: dict, *, shared_loss_beta: float = 0.1,
                    specific_loss_lamb: float = 0.1,
                    entropy_loss_ratio: float = 0.0) -> LossBreakdown:
    """The total loss (vq + commit of the three paths, the shared InfoNCE /
    alignment terms, the specific InfoNCE / orthogonality terms, and the
    optional entropy term) and the metrics dict of the JAX trainer."""
    qr = quantized_result
    codebook_loss = (
        qr["shared_embed_loss"][0] + qr["shared_embed_loss"][1]
        + qr["text_specific_loss"][0] + qr["text_specific_loss"][1]
        + qr["graph_specific_loss"][0] + qr["graph_specific_loss"][1]
    )
    s11, s12, s21, s22 = shared_loss(
        qr["shared_text_embedding"], qr["shared_graph_embedding"],
        qr["text_feature"], qr["graph_feature"],
    )
    shared_all = (s11 - shared_loss_beta * s12) + (s21 - shared_loss_beta * s22)
    p11, p12, p21, p22 = specific_loss(
        z1=qr["specific_embedding_text"],
        z1_aug=qr["specific_embedding_text_aug"],
        z2=qr["specific_embedding_graph"],
        z2_aug=qr["specific_embedding_graph_aug"],
        z1_c=qr["shared_text_embedding"],
        z2_c=qr["shared_graph_embedding"],
    )
    specific_all = (p11 + specific_loss_lamb * p12) + (p21 + specific_loss_lamb * p22)

    total = codebook_loss + shared_all + specific_all
    entropy = torch.zeros((), dtype=torch.float32, device=total.device)
    if entropy_loss_ratio > 0 and qr.get("shared_affinity") is not None:
        entropy = compute_entropy_loss(qr["shared_affinity"])
        total = total + entropy_loss_ratio * entropy
    metrics = {
        "loss": total,
        "loss_common_all": shared_all,
        "loss_common_11": s11,
        "loss_common_12": s12,
        "loss_common_21": s21,
        "loss_common_22": s22,
        "loss_specific_all": specific_all,
        "loss_specific_11": p11,
        "loss_specific_12": p12,
        "loss_specific_21": p21,
        "loss_specific_22": p22,
        "vq_loss": codebook_loss,
        "vq_shared_loss": qr["shared_embed_loss"][0],
        "vq_text_loss": qr["text_specific_loss"][0],
        "vq_graph_loss": qr["graph_specific_loss"][0],
        "commit_shared_loss": qr["shared_embed_loss"][1],
        "commit_text_loss": qr["text_specific_loss"][1],
        "commit_graph_loss": qr["graph_specific_loss"][1],
        "entropy_loss": entropy,
        "codebook_usage_shared": qr["shared_codebook_usage"],
        "codebook_usage_text": qr["text_specific_usage"],
        "codebook_usage_graph": qr["graph_specific_usage"],
    }
    return LossBreakdown(total, metrics)
