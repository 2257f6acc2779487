"""The export traffic: whole packed exports (``export_all_packed``) of
successive slices of the vocabulary, in an order drawn from the seed, one
after another (closed loop, one caller). A call's codes count once its
three outputs are back on the host."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import counts, tracing_hooks
from portbench import trace as tracing
from portbench.check import judge_export
from portbench.datagen import make_corpus
from portbench.reference.medtok import Inputs, MedTok, Precision
from portbench.weights import load_into, make_weights, reference_copy, sub_seed


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.calls: list[tuple[int, dict]] = []     # (slice, outputs) of the window
        self.seconds: list[float] = []              # each call's

    def setup(self) -> None:
        from medtok_tpu_torch.config import MedTokConfig
        from medtok_tpu_torch.data.dataset import MedCodeDataset
        from medtok_tpu_torch.data.kg import KnowledgeGraph
        from medtok_tpu_torch.data.text import WordPieceTokenizer
        from medtok_tpu_torch.export import export_all_packed
        from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

        t = self.traffic
        cfg = MedTokConfig.from_dict({"model": self.config["model"], "data": self.config["data"]})
        corpus = make_corpus(t["corpus"])
        self.corpus = corpus
        kg = KnowledgeGraph(corpus.kg_src, corpus.kg_dst, corpus.kg_rel, {}, corpus.num_nodes)
        tokenizer = WordPieceTokenizer(corpus.vocab)
        order = np.random.default_rng(sub_seed(self.seed, "order")).permutation(len(corpus))
        per = t["codes_per_call"]
        self.slices = [order[i * per:(i + 1) * per] for i in range(len(corpus) // per)]
        # one native graph runtime (its CSR and pinned pools) serves every
        # slice: each slice is the vocabulary a user would export
        self.datasets = []
        for i, sl in enumerate(self.slices):
            ds = MedCodeDataset(kg, [corpus.med_codes[j] for j in sl],
                                [corpus.descs[j] for j in sl],
                                [corpus.node_lists[j] for j in sl], tokenizer,
                                cfg=cfg.data, native=i == 0)
            if i:
                ds.native, ds._encoder = self.datasets[0].native, self.datasets[0]._encoder
            ds.warm_cache(tokenize=True)
            self.datasets.append(ds)
        self.weights = make_weights(self.config["model"], self.seed, self.device, train=False)
        self.model = MultimodalTokenizer(cfg.model, device=self.device)
        load_into(self.model, self.weights)
        self.model.eval()
        rows, row_len = t["packed_rows"]
        self.export = lambda ds: export_all_packed(self.model, ds, device=self.device,
                                                   row_len=row_len, num_rows=rows)
        self.next = 0
        for _ in range(t["warmup_calls"]):
            self._call(keep=False)

    def _call(self, keep: bool = True) -> None:
        i = self.next % len(self.datasets)
        t0 = time.perf_counter()
        out = self.export(self.datasets[i])
        self.seconds.append(time.perf_counter() - t0)
        self.next += 1
        if keep:
            self.calls.append((i, out))

    def window(self, seconds: float, trace: bool) -> dict:
        ctx = None
        t0 = time.perf_counter()
        if trace:
            self._call()                  # one steady call before the traced ones
            first = len(self.calls)
            with tracing_hooks.Recorder() as rec, torch.profiler.profile(
                    activities=tracing_hooks.activities(self.device)) as prof:
                with torch.profiler.record_function(tracing.WINDOW_RANGE):
                    for _ in range(self.traffic["trace_calls"]):
                        self._call()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
            traced = [self.slices[i] for i, _ in self.calls[first:]]
            ctx = self._ctx(prof, rec, np.concatenate(traced))
        while True:
            self._call()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        codes = sum(len(self.slices[i]) for i, _ in self.calls)
        print(f"portbench: {len(self.calls)} calls in {elapsed:.3f} s; call seconds "
              f"{[round(x, 3) for x in self.seconds]}", file=sys.stderr)
        return {"attempted": codes, "failed": 0, "ctx": ctx,
                "end_to_end": {"export_codes_per_s": codes / elapsed}}

    def inputs(self) -> Inputs:
        if not hasattr(self, "_inputs"):
            self._inputs = Inputs(self.corpus, self.config["data"], self.device)
        return self._inputs

    def _ctx(self, prof, rec, codes) -> dict:
        tr = tracing.reduce(prof, ("export.", "gcn_norm_adj"))
        t, n, e = self.inputs().sizes(codes)
        return {"trace": tr if self.device.type == "cuda" else None,
                "steps": tr.range_calls.get("export.bert", 0),
                "k1_bound_s": rec.k1_bound_s(), "k2_bound_s": rec.k2_bound_s(),
                "flops": counts.model_flops(self.config["model"], t, n, e, train=False)}

    def release(self) -> None:
        del self.model, self.datasets, self.export

    def sample(self):
        """A sample of the window's codes, drawn from the seed, with the
        longest description and the largest subgraph in it, and the
        program's outputs for them."""
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        where = [(c, r) for c, (i, _) in enumerate(self.calls) for r in range(len(self.slices[i]))]
        codes = np.array([self.slices[self.calls[c][0]][r] for c, r in where])
        words = np.array([len(self.corpus.descs[x].split()) for x in codes])
        nodes = np.array([len(self.corpus.node_lists[x]) for x in codes])
        special = {int(np.argmax(words)), int(np.argmax(nodes))}
        want = self.traffic["check_codes"]
        rest = rng.choice(len(codes), size=min(want, len(codes)), replace=False)
        pick = sorted(special | {int(x) for x in rest[:max(want - len(special), 0)]})
        got = [np.stack([self.calls[where[j][0]][1][k][where[j][1]] for j in pick])
               for k in ("tokens_all", "weights_all", "embeddings_all")]
        return codes[pick], got

    def check(self) -> dict[str, float]:
        """The sample's tokens, weights and embeddings judged by the
        reference (``check.judge_export``)."""
        codes, got = self.sample()
        self.ref = MedTok(self.config["model"], reference_copy(self.weights))
        self.batch = self.inputs().batch(codes)
        self.rows = self.ref.eval_rows(self.batch)
        return judge_export(self.ref, self.rows, *got)

    def control(self) -> dict[str, float]:
        """The same judgement of the reference itself in the program's place
        at the lower precision (after ``check``)."""
        low = MedTok(self.config["model"], self.ref.w, Precision("fp8"))
        return judge_export(self.ref, self.rows, *low.export_rows(self.batch))
