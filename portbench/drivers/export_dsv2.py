"""The export traffic of ``drivers/export.py`` with a DeepSeek-V2 text
encoder (``medtok-dsv2lite``): whole packed exports of successive slices
of the vocabulary in a seeded order, one after another.

What differs from the BERT's driver: the seeded weights are drawn straight
into the program's parameters, one tensor at a time (the model is 31 GB in
bf16: a draw in one call, or a second copy, would not fit beside it), and
the reference reads the same bf16 tensors after the program is released;
the traced window's device ms go to ``export.text`` and the encoder's
``text.*`` ranges, its operations are counted by ``counts_dsv2``, and the
experts' load is the program's device counter. After the measured window,
each slice that holds checked codes is exported again, untimed, as its
window call ran it, and each checked code's text feature (its last
token's final state, as the tail reads it) is kept for ``text_err``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import counts_dsv2
from portbench import trace as tracing
from portbench.check import judge_export
from portbench.datagen import make_corpus
from portbench.drivers.export import Run as ExportRun
from portbench.reference.deepseek_v2 import MedTokDSV2, param_spec
from portbench.reference.medtok import Precision
from portbench.weights import sub_seed

_STD = {"fan_in": lambda s: 1.0 / math.sqrt(s[-1]), "unit": lambda s: 1.0,
        "glorot": lambda s: math.sqrt(2.0 / sum(s))}


@torch.no_grad()
def draw_into(model: torch.nn.Module, model_cfg: dict, seed: int, device) -> dict:
    """Every parameter of ``param_spec`` drawn from the seed in spec order,
    a normal draw per tensor scaled per family and cast into the model's
    own tensor; returns them by name (the model's storage, not a copy)."""
    own = model.state_dict()
    spec = param_spec(model_cfg)
    if set(own) != {n for n, _, _ in spec}:
        raise ValueError(f"weights and model differ in names: "
                         f"{sorted(set(own) ^ {n for n, _, _ in spec})[:8]}")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    for name, shape, family in spec:
        t = own[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if family in ("zero", "one"):
            t.fill_(float(family == "one"))
        else:
            t.copy_(torch.randn(shape, generator=gen, device=device) * _STD[family](shape))
    return own


def text_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 error of a code's text feature."""
    got = got.to(want.device, torch.float32)
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


class Run(ExportRun):
    def setup(self) -> None:
        # a program without the encoder fails here, before the corpus is built
        from medtok_tpu_torch.config import DeepseekV2TextConfig, MedTokConfig  # noqa: F401
        from medtok_tpu_torch.data.dataset import MedCodeDataset
        from medtok_tpu_torch.data.kg import KnowledgeGraph
        from medtok_tpu_torch.data.text import WordPieceTokenizer
        from medtok_tpu_torch.export import export_all_packed
        from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

        t = self.traffic
        self.cfg = cfg = MedTokConfig.from_dict({"model": self.config["model"],
                                                 "data": self.config["data"]})
        corpus = self.corpus = make_corpus(t["corpus"])
        kg = KnowledgeGraph(corpus.kg_src, corpus.kg_dst, corpus.kg_rel, {}, corpus.num_nodes)
        self.tokenizer = WordPieceTokenizer(corpus.vocab)
        order = np.random.default_rng(sub_seed(self.seed, "order")).permutation(len(corpus))
        per = t["codes_per_call"]
        self.slices = [order[i * per:(i + 1) * per] for i in range(len(corpus) // per)]
        self.datasets = []
        for i, sl in enumerate(self.slices):
            ds = MedCodeDataset(kg, [corpus.med_codes[j] for j in sl],
                                [corpus.descs[j] for j in sl],
                                [corpus.node_lists[j] for j in sl], self.tokenizer,
                                cfg=cfg.data, native=i == 0)
            if i:
                ds.native, ds._encoder = self.datasets[0].native, self.datasets[0]._encoder
            ds.warm_cache(tokenize=True)
            self.datasets.append(ds)
        self.kg = kg
        self.model = MultimodalTokenizer(cfg.model, device=self.device)
        self.weights = draw_into(self.model, self.config["model"], self.seed, self.device)
        self.model.eval()
        self.rows_len = t["packed_rows"]
        rows, row_len = self.rows_len
        self.export = lambda ds: export_all_packed(self.model, ds, device=self.device,
                                                   row_len=row_len, num_rows=rows)
        self.next = 0
        for _ in range(t["warmup_calls"]):
            self._call(keep=False)

    def window(self, seconds: float, trace: bool) -> dict:
        out = super().window(seconds, trace)
        self._keep_features()
        return out

    def _keep_features(self) -> None:
        """Each checked code's text feature from its own window call, made
        again untimed: for each slice the sample reaches, the same dataset
        (native host route), groups and model through ``export_all_packed``,
        with a forward pre-hook on ``text_mapped`` that keeps the first row
        of each step's gathered states (a code's last token's final state,
        the row the tail reads first)."""
        from medtok_tpu_torch.export import export_groups

        codes, got = self.sample()
        rows, row_len = self.rows_len
        slice_of = {int(x): i for i, _ in self.calls for x in self.slices[i]}
        where = {}                                  # slice -> {code: sample row}
        for n, code in enumerate(codes):
            where.setdefault(slice_of[int(code)], {})[int(code)] = n
        feats = None
        for i, picked in sorted(where.items()):
            pooled = []
            hook = self.model.text_mapped.register_forward_pre_hook(
                lambda _module, args: pooled.append(args[0][:, 0].float()))
            try:
                self.export(self.datasets[i])
            finally:
                hook.remove()
            groups = export_groups(self.datasets[i], row_len=row_len, num_rows=rows)
            if len(pooled) != len(groups):
                raise RuntimeError(f"text_mapped ran {len(pooled)} times over "
                                   f"{len(groups)} packed steps")
            if feats is None:
                feats = torch.zeros((len(codes), pooled[0].shape[1]), device=pooled[0].device)
            for group, p in zip(groups, pooled):
                for r, j in enumerate(group):
                    n = picked.get(int(self.slices[i][j]))
                    if n is not None:
                        feats[n] = p[r]
        self._checked = (codes, got, feats)

    def _ctx(self, prof, rec, codes) -> dict:
        from medtok_tpu_torch.export import export_groups
        from medtok_tpu_torch.utils.profiling import read_device_counts

        tr = tracing.reduce(prof, ("export.", "text.", "gcn_norm_adj"))
        t, n, e = self.inputs().sizes(codes)
        rows, row_len = self.rows_len
        traced = [i for i, _ in self.calls[-self.traffic["trace_calls"]:]]
        per_step = [int(self.datasets[i].text_lengths(0, len(self.datasets[i]))[g].sum())
                    for i in traced
                    for g in export_groups(self.datasets[i], row_len=row_len, num_rows=rows)]
        load = {k: v for k, v in read_device_counts().items()
                if k.startswith("moe.expert_load.")}
        text = self.config["model"]["text"]
        return {"trace": tr if self.device.type == "cuda" else None,
                "steps": tr.range_calls.get("export.text", 0),
                "k1_bound_s": rec.k1_bound_s(), "k2_bound_s": rec.k2_bound_s(),
                "experts_bound_s": counts_dsv2.experts_bound_s(text, per_step),
                "expert_load": load,
                "flops": counts_dsv2.model_flops(self.config["model"], t, n, e)}

    def release(self) -> None:
        # the text encoder's bf16 tensors stay in self.weights for the reference
        del self.model, self.datasets, self.export

    def check(self) -> dict[str, float]:
        """``judge_export``'s three numbers on the checked codes, and
        ``text_err``: the largest relative L2 error of a code's text feature
        against the reference encoder's."""
        codes, got, feats = self._checked
        w = {k: (v if k.startswith("text_model.") else v.detach().float().clone())
             for k, v in self.weights.items()}
        self.ref = MedTokDSV2(self.config["model"], w)
        self.batch = self.inputs().batch(codes)
        self.rows = self.ref.eval_rows(self.batch)
        self.ref_text = self.ref.pooled_text(self.batch.input_ids, self.batch.text_mask)
        out = judge_export(self.ref, self.rows, *got)
        out["text_err"] = text_err(feats, self.ref_text)
        return out

    def control(self) -> dict[str, float]:
        """The reference in the program's place at the lower precision."""
        low = MedTokDSV2(self.config["model"], self.ref.w, Precision("fp8"))
        out = judge_export(self.ref, self.rows, *low.export_rows(self.batch))
        out["text_err"] = text_err(low.pooled_text(self.batch.input_ids, self.batch.text_mask),
                                   self.ref_text)
        return out
