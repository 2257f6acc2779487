"""Full-vocabulary export, sequence-packed (counterpart of
``medtok_tpu/export/export.py::_export_all_packed``).

Length-sorted descriptions share fixed [num_rows, row_len] BERT rows (one
text-encoder shape for the whole sweep, block-diagonal attention through
kernel K2); the quantizer tail (four K1 sweeps) runs on the group's codes
padded by repetition to a code-count bucket. Each group's rows are written
at their code indices, so the artifacts are in vocabulary order:
``embeddings_all [N, 256]``, ``tokens_all [N, 4, k]``, ``weights_all [N, 4, k]``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.data.dataset import MedCodeDataset
from medtok_tpu_torch.data.packing import derive_packed_meta, iter_groups
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

CODE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
# groups in flight before the oldest result is copied back: the host packs
# the next groups while the device works
_PREFETCH = 2


def packed_layout(dataset: MedCodeDataset, *, row_len: int | None = None,
                  num_rows: int | None = None) -> tuple[int, int, int]:
    """(row_len, num_rows, lmax) of the packed sweep: rows hold the longest
    text bucket, ~32K tokens per step."""
    lmax = max(dataset.cfg.text_buckets)
    if row_len is None:
        row_len = max(128, lmax)
    if num_rows is None:
        num_rows = max(32768 // row_len, 8)
    if lmax > row_len:
        raise ValueError(f"text bucket {lmax} exceeds pack row_len {row_len}")
    return row_len, num_rows, lmax


def code_buckets(n: int) -> list[int]:
    """Code-count buckets of the quantizer step for an n-code vocabulary."""
    buckets = [c for c in CODE_BUCKETS if c <= 4 * n]
    if not buckets or buckets[-1] < min(n, CODE_BUCKETS[-1]):
        buckets.append(min(-(-max(n, 8) // 8) * 8, CODE_BUCKETS[-1]))
    return buckets


def export_groups(dataset: MedCodeDataset, *, row_len: int | None = None,
                  num_rows: int | None = None) -> list[np.ndarray]:
    """The code groups of the packed sweep, one per BERT step and quantizer
    step (the dataset must be tokenized: ``warm_cache``)."""
    row_len, num_rows, _ = packed_layout(dataset, row_len=row_len, num_rows=num_rows)
    n = len(dataset)
    return list(iter_groups(dataset.text_lengths(0, n), row_len=row_len,
                            num_rows=num_rows, max_codes=code_buckets(n)[-1]))


@torch.no_grad()
def export_all_packed(
    model: MultimodalTokenizer,
    dataset: MedCodeDataset,
    *,
    device: str | torch.device | None = None,
    out_dir: str | Path | None = None,
    row_len: int | None = None,
    num_rows: int | None = None,
) -> dict[str, np.ndarray]:
    """Sweep the whole vocabulary; returns (and optionally saves) the three
    artifacts. Runs on CUDA unless ``device`` names another device."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    n = len(dataset)
    k = model.cfg.quantizer.top_k
    row_len, num_rows, lmax = packed_layout(dataset, row_len=row_len,
                                            num_rows=num_rows)
    buckets = code_buckets(n)
    embeddings = np.zeros((n, model.cfg.embedding_dim), np.float32)
    tokens = np.zeros((n, 4, k), np.int32)
    weights = np.zeros((n, 4, k), np.float32)

    dataset.warm_cache()
    inflight = []

    def drain(item):
        group, out = item
        m = len(group)
        embeddings[group] = out.embedding[:m].cpu().numpy()
        tokens[group] = out.tokens[:m].cpu().numpy()
        weights[group] = out.weights[:m].cpu().numpy()

    # the record_function ranges name the host phases in a torch.profiler
    # trace (chip_smoke.py reads them); they cost nothing when no profiler runs
    for group in export_groups(dataset, row_len=row_len, num_rows=num_rows):
        C = next((c for c in buckets if len(group) <= c), buckets[-1])
        pad = C - len(group)
        with record_function("export.pack_text"):
            ids_np, base_np, lens_np = dataset.pack_text_rows(
                group, row_len=row_len, num_rows=num_rows)
            base = torch.from_numpy(np.concatenate([base_np, np.repeat(base_np[-1:], pad)]))
            lens = torch.from_numpy(np.concatenate([lens_np, np.repeat(lens_np[-1:], pad)]))
        with record_function("export.make_batch"):
            codes = np.concatenate([group, np.repeat(group[-1:], pad)])
            batch = dataset.make_batch(codes.tolist())
        with record_function("export.to_device"):
            batch = batch.to(dev)
            ids = torch.from_numpy(ids_np).to(dev)
            seg, pos, gidx, tmask = derive_packed_meta(
                base.to(dev), lens.to(dev), num_rows=num_rows, row_len=row_len,
                lmax=lmax)
        with record_function("export.bert"):
            flat = model.encode_text_packed(ids, seg, pos)
        with record_function("export.quantize"):
            out = model.tokenize_from_hidden(flat, gidx, tmask, batch)
        inflight.append((group, out))
        if len(inflight) > _PREFETCH:
            with record_function("export.drain"):
                drain(inflight.pop(0))
    with record_function("export.drain"):
        while inflight:
            drain(inflight.pop(0))

    arrays = {"embeddings_all": embeddings, "tokens_all": tokens,
              "weights_all": weights}
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, arr in arrays.items():
            np.save(out_dir / f"{name}.npy", arr)
    return arrays
