"""Full-vocabulary export (counterpart of ``medtok_tpu/export/export.py``).

``export_all_packed``: length-sorted descriptions share fixed
[num_rows, row_len] BERT rows (one text-encoder shape for the whole sweep,
block-diagonal attention through kernel K2); the quantizer tail (four K1
sweeps) runs on the group's codes padded by repetition to a code-count
bucket. The host ships each step's text rows as int16 when the vocabulary
allows and its graphs as a compact batch (``make_batch_compact``: on the
native route the C++ packer's pooled buffers, pinned for the card, copied
asynchronously and fenced), which ``unpack_compact`` expands on the
device. ``export_all``: the unpacked sweep, batches of ``batch_size`` codes
in vocabulary order through the model's forward (a dense-attention BERT
over each batch's padded texts, then the four K1 sweeps), the tail batch
padded with repeats of its last code; ``packed=True`` takes the packed
sweep. Each batch's rows are written at their code indices, so the
artifacts are in vocabulary order: ``embeddings_all [N, 256]``,
``tokens_all [N, 4, k]``, ``weights_all [N, 4, k]``.

Both take ``dp=``, the ``DataParallel`` of ``parallel/mesh.py``
(``initialize_distributed``): every rank computes the same step list (the
packed route's groups, the unpacked route's batches) and runs steps
rank, rank + world, ... in full; one exact all-gather then gives every rank
the three whole arrays, and rank 0 alone writes them while the others wait
on a barrier. ``last_gather`` holds the gather's seconds and bytes.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.data.compact import unpack_compact
from medtok_tpu_torch.data.dataset import MedCodeDataset
from medtok_tpu_torch.data.packing import derive_packed_meta, iter_groups
from medtok_tpu_torch.models.deepseek_v2 import count_routed
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
from medtok_tpu_torch.parallel.mesh import DataParallel
from medtok_tpu_torch.utils.profiling import count, span

CODE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
# groups in flight before the oldest result is copied back: the host packs
# the next groups while the device works
_PREFETCH = 2
#: the last data-parallel gather: its seconds and the bytes of the gathered buffer
last_gather: dict[str, float] = {"seconds": 0.0, "bytes": 0}


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
    dp: DataParallel | None = None,
) -> dict[str, np.ndarray]:
    """Sweep the whole vocabulary; returns (and optionally saves) the three
    artifacts. Runs on CUDA unless ``device`` names another device; with
    ``dp`` on the rank's device, its share of the groups (see the module
    docstring)."""
    dev = resolve_device(device) if dp is None else dp.device
    with span("export.plan"):
        model = model.to(dev).eval()
        n = len(dataset)
        k = model.cfg.quantizer.top_k
        row_len, num_rows, lmax = packed_layout(dataset, row_len=row_len,
                                                num_rows=num_rows)
        buckets = code_buckets(n)
        embeddings = np.zeros((n, model.cfg.embedding_dim), np.float32)
        tokens = np.zeros((n, 4, k), np.int32)
        weights = np.zeros((n, 4, k), np.float32)

        dataset.warm_cache(tokenize=True)
        # int16 text rows when every id fits, widened to int32 on the device
        text_dtype = np.int16 if model.cfg.text.vocab_size < 32768 else np.int32
        pinned = dev.type == "cuda"
        inflight = []
        steps = export_groups(dataset, row_len=row_len, num_rows=num_rows)
        # the BERT keeps its range's name; another text encoder runs under export.text
        text_range = "export.text" if model.causal_text else "export.bert"

    def drain(item):
        group, out = item
        m = len(group)
        embeddings[group] = out.embedding[:m].cpu().numpy()
        tokens[group] = out.tokens[:m].cpu().numpy()
        weights[group] = out.weights[:m].cpu().numpy()

    # the spans name the host phases in a torch.profiler trace (portbench/ and
    # chip_smoke.py read them); with no profiler running each is one flag check
    for group in _own_steps(steps, dp):
        C = next((c for c in buckets if len(group) <= c), buckets[-1])
        pad = C - len(group)
        count("quantize.codes", len(group))
        count("quantize.code_slots", C)
        with span("export.pack_text"):
            ids_np, base_np, lens_np = dataset.pack_text_rows(
                group, row_len=row_len, num_rows=num_rows)
            count_routed(model.cfg.text, lens_np.sum(), ids_np.size)
            base = torch.from_numpy(np.concatenate([base_np, np.repeat(base_np[-1:], pad)]))
            lens = torch.from_numpy(np.concatenate([lens_np, np.repeat(lens_np[-1:], pad)]))
        with span("export.make_batch"):
            codes = np.concatenate([group, np.repeat(group[-1:], pad)])
            compact, fence = dataset.make_batch_compact(codes.tolist(), want_text=False,
                                                        pinned=pinned, real=len(group))
        with span("export.to_device"):
            compact = compact.to(dev)
            # the pooled buffers are reused after their copies are done
            fence.set_fence(dev)
            ids = torch.from_numpy(ids_np.astype(text_dtype)).to(dev).to(torch.int32)
            seg, pos, gidx, tmask = derive_packed_meta(
                base.to(dev), lens.to(dev), num_rows=num_rows, row_len=row_len,
                lmax=lmax)
        with span("export.unpack"):
            batch = unpack_compact(compact)
        with span(text_range):
            flat = model.encode_text_packed(ids, seg, pos)
        with span("export.quantize"):
            out = model.tokenize_from_hidden(flat, gidx, tmask, batch)
        inflight.append((group, out))
        if len(inflight) > _PREFETCH:
            with span("export.drain"):
                drain(inflight.pop(0))
    with span("export.drain"):
        while inflight:
            drain(inflight.pop(0))
    with span("export.finish"):
        return _finish({"embeddings_all": embeddings, "tokens_all": tokens,
                        "weights_all": weights}, steps, dp, out_dir)


def _own_steps(steps: list[np.ndarray], dp: DataParallel | None) -> list[np.ndarray]:
    """This rank's steps: rank r of the world runs steps r, r + world, ...
    in full.

    Ranks take whole steps rather than a share of every step's rows: each
    step then runs the kernels at the one-device shapes (so the arrays are
    bitwise the one-device export's), the host packing and copies split
    with the device work, and no collective runs inside a step (sharding a
    BERT step's rows would change the GEMM shapes and need an all-gather of
    the hidden states a step). The one gather comes after the sweep."""
    return steps if dp is None else steps[dp.rank::dp.world]


def _finish(arrays: dict[str, np.ndarray], steps: list[np.ndarray],
            dp: DataParallel | None, out_dir: str | Path | None) -> dict[str, np.ndarray]:
    """Gather the ranks' rows (data parallel), then save (rank 0 alone)."""
    if dp is None:
        return _save(arrays, out_dir)
    _gather_rows(arrays, steps, dp)
    if dp.rank == 0:
        _save(arrays, out_dir)
    dp.barrier()
    return arrays


def _gather_rows(arrays: dict[str, np.ndarray], steps: list[np.ndarray],
                 dp: DataParallel) -> None:
    """Fill every rank's arrays with the rows of the other ranks' steps.

    Each rank sends its own rows as one int32 buffer (the fp32 arrays by
    their bits, so the copy is exact, -0.0 and NaN included), padded to the
    longest rank's rows; one all-gather over the group (on the card for
    NCCL, on the host for gloo), and each rank's rows go back to the code
    indices of its steps, which every rank knows."""
    t0 = time.perf_counter()
    n = len(next(iter(arrays.values())))
    views = [a.reshape(n, -1).view(np.int32) for a in arrays.values()]
    owned = [np.concatenate([np.asarray(s, np.int64) for s in steps[r::dp.world]] or
                            [np.zeros(0, np.int64)]) for r in range(dp.world)]
    rows = max(max(len(o) for o in owned), 1)
    width = sum(v.shape[1] for v in views)
    mine = owned[dp.rank]
    send = np.zeros((rows, width), np.int32)
    send[:len(mine)] = np.concatenate([v[mine] for v in views], axis=1)
    got = dp.all_gather(torch.from_numpy(send).to(dp.comm_device), axis=None)
    got = got.cpu().numpy().reshape(dp.world, rows, width)
    for r, idx in enumerate(owned):
        if r == dp.rank:
            continue
        col = 0
        for v in views:
            v[idx] = got[r, :len(idx), col:col + v.shape[1]]
            col += v.shape[1]
    last_gather.update(seconds=time.perf_counter() - t0, bytes=got.nbytes)


def _save(arrays: dict[str, np.ndarray], out_dir: str | Path | None) -> dict[str, np.ndarray]:
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, arr in arrays.items():
            np.save(out_dir / f"{name}.npy", arr)
    return arrays


@torch.no_grad()
def export_all(
    model: MultimodalTokenizer,
    dataset: MedCodeDataset,
    *,
    batch_size: int = 1024,
    packed: bool = False,
    device: str | torch.device | None = None,
    out_dir: str | Path | None = None,
    dp: DataParallel | None = None,
) -> dict[str, np.ndarray]:
    """Sweep the whole vocabulary in batches of ``batch_size`` codes;
    returns (and optionally saves) the three artifacts. ``packed=True``
    takes ``export_all_packed`` (``batch_size`` unused). Runs on CUDA unless
    ``device`` names another device; with ``dp`` on the rank's device, its
    share of the batches (see the module docstring)."""
    if packed:
        return export_all_packed(model, dataset, device=device, out_dir=out_dir, dp=dp)
    dev = resolve_device(device) if dp is None else dp.device
    with span("export.plan"):
        model = model.to(dev).eval()
        n = len(dataset)
        k = model.cfg.quantizer.top_k
        embeddings = np.zeros((n, model.cfg.embedding_dim), np.float32)
        tokens = np.zeros((n, 4, k), np.int32)
        weights = np.zeros((n, 4, k), np.float32)
        inflight = []
        steps = [np.arange(start, min(start + batch_size, n))
                 for start in range(0, n, batch_size)]

    def drain(item):
        idxs, out = item
        m = len(idxs)
        embeddings[idxs] = out.embedding[:m].cpu().numpy()
        tokens[idxs] = out.tokens[:m].cpu().numpy()
        weights[idxs] = out.weights[:m].cpu().numpy()

    for idxs in _own_steps(steps, dp):
        with span("export.make_batch"):
            # the tail batch is padded to full size with repeats of its last code
            ids = idxs.tolist() + [int(idxs[-1])] * (batch_size - len(idxs))
            batch = dataset.make_batch(ids, real=len(idxs))
            count_routed(model.cfg.text, np.count_nonzero(batch.attention_mask),
                         batch.attention_mask.size)
        with span("export.to_device"):
            batch = batch.to(dev)
        with span("export.forward"):
            out = model(batch)
        inflight.append((idxs, out))
        if len(inflight) > _PREFETCH:
            with span("export.drain"):
                drain(inflight.pop(0))
    with span("export.drain"):
        while inflight:
            drain(inflight.pop(0))
    with span("export.finish"):
        return _finish({"embeddings_all": embeddings, "tokens_all": tokens,
                        "weights_all": weights}, steps, dp, out_dir)
