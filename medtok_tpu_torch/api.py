"""Public per-code API: tokenize / encode / embed (counterpart of
``medtok_tpu/api.py::MedTok``).

    tok = MedTok.from_npz("args.json", "params.npz", dataset)   # on CUDA
    tokens = tok.tokenize("E11.9")   # [4, k] token ids
    ids    = tok.encode("E11.9")     # flat [4*k] ids
    embed  = tok.embed("E11.9")      # [256] embedding
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from medtok_tpu_torch import resolve_device
from medtok_tpu_torch.config import MedTokConfig
from medtok_tpu_torch.convert import load_params
from medtok_tpu_torch.data.dataset import MedCodeDataset, collate
from medtok_tpu_torch.data.types import TokenizedCodes
from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer


class MedTok:
    """Serves codes of ``dataset`` through ``model``; runs on CUDA unless
    ``device`` names another device."""

    def __init__(self, cfg: MedTokConfig, model: MultimodalTokenizer,
                 dataset: MedCodeDataset, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset = dataset

    @classmethod
    def from_npz(cls, config_path: str | Path, params_path: str | Path,
                 dataset: MedCodeDataset, *, device=None) -> "MedTok":
        """Rebuild the model from an ``args.json`` and a ``/``-keyed params
        .npz (see ``convert.py``)."""
        dev = resolve_device(device)
        cfg = MedTokConfig.load(config_path)
        model = load_params(MultimodalTokenizer(cfg.model, device=dev), params_path)
        return cls(cfg, model, dataset, device=dev)

    @torch.no_grad()
    def _run(self, med_code: str) -> TokenizedCodes:
        idx = self.dataset.lookup(med_code)
        batch = collate([self.dataset[idx]], self.dataset.cfg,
                        pad_id=self.dataset.tokenizer.pad_id)
        return self.model(batch.to(self.device))

    def tokenize(self, med_code: str) -> np.ndarray:
        """[4, k] token ids (rows: text, graph, shared-text, shared-graph;
        specific rows are region-local ids)."""
        return self._run(med_code).tokens[0].cpu().numpy()

    def encode(self, med_code: str) -> np.ndarray:
        """Flat [4*k] token id sequence."""
        return self.tokenize(med_code).reshape(-1)

    def embed(self, med_code: str) -> np.ndarray:
        """[256] quantized embedding (the 4 paths concatenated)."""
        return self._run(med_code).embedding[0].cpu().numpy()

    @torch.no_grad()
    def tokenize_batch(self, med_codes: list[str]) -> TokenizedCodes:
        """(embeddings [N, 256], tokens [N, 4, k], weights [N, 4, k]) as numpy."""
        batch = self.dataset.make_batch([self.dataset.lookup(c) for c in med_codes])
        out = self.model(batch.to(self.device))
        return TokenizedCodes(*(t.cpu().numpy() for t in out))
