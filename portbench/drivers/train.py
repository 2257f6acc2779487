"""The training traffic: ``Trainer.fit`` over ``epoch_batches`` of the
vocabulary (seeded order, edge dropout), packed text, one process on one
card, as a user runs it: the host batch build, packing and copies in series
with each step. Set-up drives the same trainer through its first steps,
which the reference follows; the window continues it."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import counts, tracing_hooks
from portbench import trace as tracing
from portbench.check import leaf_gap, token_gap
from portbench.datagen import make_corpus
from portbench.reference.medtok import (
    FIFO_ORDER,
    ClippedAdam,
    Inputs,
    MedTok,
    Precision,
    aug_seed,
    epoch_codes,
    is_trainable,
    train_loss,
)
from portbench.weights import load_into, make_weights, reference_copy, sub_seed


class Feed:
    """The batches ``fit`` draws: ``epoch_batches`` until the deadline,
    each draw timed; while tracing, the profiler runs over ``trace`` steps
    from the ``start``-th draw of the window."""

    def __init__(self, batches, device):
        self.batches, self.device = batches, device
        self.deadline = None
        self.drawn = 0
        self.build_ms: list[float] = []
        self.trace_at = None
        self.tracer = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.trace_at is not None and self.drawn == self.trace_at[1] and self.tracer:
            self.stop_trace()
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        if self.trace_at is not None and self.drawn == self.trace_at[0]:
            self.start_trace()
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.build_ms.append(1e3 * (time.perf_counter() - t0))
        self.drawn += 1
        return batch

    def start_trace(self):
        self.trace_span = [time.perf_counter(), None]
        rec = tracing_hooks.Recorder().__enter__()
        prof = torch.profiler.profile(activities=tracing_hooks.activities(self.device))
        prof.start()
        window = torch.profiler.record_function(tracing.WINDOW_RANGE)
        window.__enter__()
        self.tracer = (rec, prof, window)

    def stop_trace(self):
        rec, prof, window = self.tracer
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window.__exit__(None, None, None)
        prof.stop()
        rec.__exit__(None, None, None)
        self.traced = (rec, prof)
        self.tracer = None
        self.trace_span[1] = time.perf_counter()


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.order_seed = sub_seed(seed, "order") >> 24      # fits epoch_batches' arithmetic
        self.gen_seed = sub_seed(seed, "dropout")
        self.log_t: list[float] = []
        self.losses: list[float] = []

    def setup(self) -> None:
        from medtok_tpu_torch.config import MedTokConfig
        from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
        from medtok_tpu_torch.data.kg import KnowledgeGraph
        from medtok_tpu_torch.data.text import WordPieceTokenizer
        from medtok_tpu_torch.train.trainer import Trainer

        t = self.traffic
        cfg = MedTokConfig.from_dict({"model": self.config["model"],
                                      "data": self.config["data"], "train": t["train"]})
        corpus = make_corpus(t["corpus"])
        self.corpus = corpus
        kg = KnowledgeGraph(corpus.kg_src, corpus.kg_dst, corpus.kg_rel, {}, corpus.num_nodes)
        dataset = MedCodeDataset(kg, corpus.med_codes, corpus.descs, corpus.node_lists,
                                 WordPieceTokenizer(corpus.vocab), cfg=cfg.data)
        dataset.warm_cache(tokenize=True)
        self.weights = make_weights(self.config["model"], self.seed, self.device, train=True)
        self.trainer = Trainer(cfg, device=self.device, log_fn=self._log)
        self.state = self.trainer.init_state()
        load_into(self.trainer.model, self.weights)
        self.state.generator.manual_seed(self.gen_seed)
        self.names = [n for n, p in self.trainer.model.named_parameters() if is_trainable(n)]

        def epochs():
            epoch = 0
            while True:
                yield from epoch_batches(dataset, batch_size=cfg.train.global_batch_size,
                                         seed=self.order_seed, epoch=epoch)
                epoch += 1

        self.feed = Feed(epochs(), self.device)
        self.state = self.trainer.fit(self.state, self.feed, max_steps=t["check_steps"])
        self.set_up_steps = self.state.step

    def _log(self, step: int, metrics: dict) -> None:
        """After every step: its time and loss; after the first, the
        optimizer's first moments and the usage FIFO's newest entries;
        after the last checked step, the parameters."""
        self.log_t.append(time.perf_counter())
        self.losses.append(metrics["loss"])
        model = self.trainer.model
        if step == 1:
            per_step = 6 * self.traffic["train"]["global_batch_size"] * \
                self.config["model"]["quantizer"]["top_k"]
            self.fifo1 = model.quantize.codebook_used[-per_step:].clone()
            self.mu1 = {n: m.clone() for n, m in zip(self.names, self.state.opt_state.mu)}
        if step == self.traffic["check_steps"]:
            params = dict(model.named_parameters())
            self.params_after = {n: params[n].detach().clone() for n in self.names}

    def window(self, seconds: float, trace: bool) -> dict:
        feed = self.feed
        first_draw = feed.drawn
        if trace:
            start = first_draw + 1          # one steady step before the traced ones
            feed.trace_at = (start, start + self.traffic["trace_steps"])
            # the profiler's first start in a process is slow: pay it here
            with torch.profiler.profile(activities=tracing_hooks.activities(self.device)):
                pass
        t0 = time.perf_counter()
        mark = len(self.log_t)
        feed.deadline = t0 + seconds
        self.state = self.trainer.fit(self.state, feed)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if feed.tracer is not None:
            feed.stop_trace()
        steps = self.state.step - self.set_up_steps
        batch = self.traffic["train"]["global_batch_size"]
        ends = self.log_t[mark:]
        step_ms = np.diff([t0] + ends) * 1e3
        build = np.array(feed.build_ms[first_draw:first_draw + len(step_ms)])

        def quarters(ms):
            return [round(float(q.mean()), 1) for q in np.array_split(ms, 4) if len(q)]

        print(f"portbench: {steps} steps in {elapsed:.3f} s; by quarter of the window, step ms "
              f"{quarters(step_ms)}, batch build ms {quarters(build)}", file=sys.stderr)
        ctx = None
        if trace:
            # steps the profiler ran in, started or stopped in are left out
            begins = [t0] + ends[:-1]
            lo, hi = feed.trace_span
            step_ms = [1e3 * (e - b) for b, e in zip(begins, ends) if e < lo or b > hi]
            ctx = self._ctx(feed, first_draw, step_ms)
        return {"attempted": steps * batch, "failed": 0, "ctx": ctx,
                "end_to_end": {"train_codes_per_s": steps * batch / elapsed}}

    def _ctx(self, feed: Feed, first_draw: int, step_ms) -> dict:
        rec, prof = feed.traced
        start, stop = feed.trace_at
        stop = min(stop, feed.drawn)
        tr = tracing.reduce(prof, ("train.", "gcn_norm_adj"))
        batch = self.traffic["train"]["global_batch_size"]
        inputs = Inputs(self.corpus, self.config["data"], self.device)
        per_epoch = len(self.corpus) // batch
        codes = np.concatenate([epoch_codes(len(self.corpus), self.order_seed, i // per_epoch,
                                            batch, i % per_epoch) for i in range(start, stop)])
        t, n, e = inputs.sizes(codes)
        return {"trace": tr if self.device.type == "cuda" else None,
                "steps": stop - start, "step_ms": list(step_ms),
                "host_batch_ms": feed.build_ms[first_draw:start] + feed.build_ms[stop:],
                "k1_bound_s": rec.k1_bound_s(), "k2_bound_s": rec.k2_bound_s(),
                "flops": counts.model_flops(self.config["model"], t, n, e, train=True)}

    def release(self) -> None:
        del self.trainer, self.state, self.feed

    def check(self) -> dict[str, float]:
        """The reference follows the checked steps from the same weights,
        batches and dropout generator. ``loss_gap``: the largest relative
        difference of a step's loss; ``grad_gap``: the worst leaf's gap of
        the first step's clipped gradient (the program's read from Adam's
        first moment); ``update_gap``: the worst leaf's gap of the change
        over the checked steps, leaves whose reference gradient is under a
        thousandth of the median leaf's left out; ``fifo_gap``: the widest
        token gap of the usage FIFO's entries from the first step."""
        self.ref = reference_steps(self.config, self.traffic, self.corpus, self.weights,
                                   self.order_seed, self.gen_seed, self.device)
        beta1 = self.traffic["train"]["beta1"]
        return self.judge({
            "losses": self.losses[:self.traffic["check_steps"]],
            "grad": {n: m / (1.0 - beta1) for n, m in self.mu1.items()},
            "delta": {n: self.params_after[n] - self.weights[n].float() for n in self.names},
            "fifo": self.fifo1})

    def control(self) -> dict[str, float]:
        """The same judgement of the reference itself in the program's place
        at the lower precision (after ``check``)."""
        low = reference_steps(self.config, self.traffic, self.corpus, self.weights,
                              self.order_seed, self.gen_seed, self.device, Precision("fp8"))
        fifo = []
        for group in FIFO_ORDER:
            fifo.append(torch.cat([low["sweeps"][n]["indices"] for n in group], -1).reshape(-1))
        return self.judge(dict(low, fifo=torch.cat(fifo)))

    def judge(self, got: dict) -> dict[str, float]:
        ref = self.ref
        norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["grad"].items()}
        floor = 1e-3 * float(np.median(list(norms.values())))
        moved = {n for n, v in norms.items() if v >= floor}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
                "grad_gap": leaf_gap(got["grad"], ref["grad"]),
                "update_gap": leaf_gap(got["delta"], ref["delta"], moved),
                "fifo_gap": fifo_gap(ref["model"], ref["sweeps"], got["fifo"])}


def fifo_gap(ref: MedTok, sweeps: dict, fifo: torch.Tensor) -> float:
    """The widest token gap of one step's usage-FIFO entries, split in
    ``FIFO_ORDER``, against the reference's rows of that step."""
    B, k = sweeps["text"]["indices"].shape
    at, worst = 0, 0.0
    for group in FIFO_ORDER:
        block = fifo[at:at + B * k * len(group)].view(B, len(group), k).to(ref.w[
            "quantize.codebook"].device)
        at += B * k * len(group)
        for j, name in enumerate(group):
            region = name.replace("_aug", "")
            worst = max(worst, float(token_gap(ref, sweeps[name]["z_n"].detach(),
                                               block[:, j], region).max()))
    return worst


def reference_steps(config: dict, traffic: dict, corpus, weights: dict, order_seed: int,
                    gen_seed: int, device, precision=None) -> dict:
    """The checked steps in the reference: (losses, the first step's
    clipped gradients, the change over the steps, the first step's sweeps
    and the model that made them)."""
    tr = traffic["train"]
    batch = tr["global_batch_size"]
    inputs = Inputs(corpus, config["data"], device)
    start = reference_copy(weights)
    params = {n: v.clone().requires_grad_(True) for n, v in start.items() if is_trainable(n)}
    frozen = {n: v for n, v in start.items() if not is_trainable(n)}
    adam = ClippedAdam(params, tr)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    out = {"losses": []}
    for i in range(traffic["check_steps"]):
        b = inputs.batch(epoch_codes(len(corpus), order_seed, 0, batch, i),
                         aug_seed=aug_seed(order_seed, 0, i))
        model = MedTok(config["model"], {**frozen, **params}, precision)
        loss, sweeps = train_loss(model, b, gen, tr)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        clipped = adam.clip(grads)
        if i == 0:
            # the codebook these sweeps read, before the step moves it
            cb = {"quantize.codebook": params["quantize.codebook"].detach().clone()}
            out.update(grad=clipped, model=MedTok(config["model"], cb, precision),
                       sweeps={n: {"z_n": q["z_n"].detach(), "indices": q["indices"]}
                               for n, q in sweeps.items()})
        adam.step(params, clipped)
        out["losses"].append(float(loss.detach()))
    out["delta"] = {n: p.detach() - start[n] for n, p in params.items()}
    return out
