"""QA evaluation: soft-prompted generation and answer accuracy (counterpart
of ``medtok_tpu/qa/inference.py``).

``num_miss_rows`` random frozen rows are appended to the embedding table
for null / sentinel ids, each batch's prompts are packed by the soft prompt
and continued by ``generate`` (64 new tokens, temperature 0.4, top-p 0.9 by
default), and the answer letter parsed from the decoded text is scored. On
a (dp, tp) mesh each dp block generates for its share of every batch's
rows (its tp ranks together, ``generate``'s tp route) and the blocks'
predictions are gathered in row order on every rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from medtok_tpu_torch.qa.finetune import QAFinetuner, _collate_rows
from medtok_tpu_torch.qa.llama import generate
from medtok_tpu_torch.qa.prompting import accuracy, parse_answer


def extend_with_miss_rows(
    embeddings: np.ndarray, num_miss_rows: int = 100, seed: int = 0
) -> np.ndarray:
    """The table with ``num_miss_rows`` N(0, 1) rows from
    ``np.random.default_rng(seed)`` appended."""
    rng = np.random.default_rng(seed)
    miss = rng.normal(size=(num_miss_rows, embeddings.shape[-1])).astype(
        embeddings.dtype
    )
    return np.concatenate([embeddings, miss], axis=0)


@torch.no_grad()
def evaluate_qa(
    finetuner: QAFinetuner,
    rows: list[dict],
    labels: list[str],
    decode_fn: Callable[[np.ndarray], str],
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.4,
    top_p: float = 0.9,
    eos_token_id: int | None = None,
    batch_size: int = 8,
    seed: int = 0,
) -> tuple[float, list[str]]:
    """rows: packed examples (prompt only, no answer tokens). Returns
    (accuracy, predictions). The draws of every batch come from one
    generator seeded by ``seed`` on the finetuner's device (on a mesh, one
    a dp block)."""
    cl = finetuner.cfg.cutoff_len
    dev = finetuner.device
    mesh = finetuner.mesh
    generator = torch.Generator(device=dev).manual_seed(seed)
    preds: list[tuple[int, str]] = []
    for start in range(0, len(rows), batch_size):
        mine = range(start, min(start + batch_size, len(rows)))
        if mesh is not None:
            mine = np.array_split(np.asarray(mine), mesh.dp_size)[mesh.dp_index].tolist()
            if not mine:
                continue
        chunk = [rows[i] for i in mine]
        batch = _collate_rows(chunk, cutoff_len=cl)
        packed = finetuner.soft_prompt(
            torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev),
            torch.as_tensor(batch["attention_mask"], dtype=torch.long, device=dev),
            None, finetuner.model.embed, finetuner.cfg.total_len,
        )
        out_ids = generate(
            finetuner.model, packed.inputs_embeds, packed.attention_mask,
            max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
            eos_token_id=eos_token_id, generator=generator, device=dev,
        )
        for i, row in enumerate(mine):
            preds.append((row, parse_answer(decode_fn(out_ids[i]), labels[row])))
    if mesh is not None:
        # tp rank 0 of each block speaks for it
        gathered = mesh.all_gather_object(preds if mesh.tp_index == 0 else [])
        preds = sorted(p for part in gathered for p in part)
    preds = [p for _, p in preds]
    return accuracy(preds, labels[: len(preds)]), preds
