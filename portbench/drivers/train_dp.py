"""The data-parallel training traffic: ``Trainer.fit`` under DDP, ``world``
ranks (4 in ``train-dp4``), one process and one card each, over NCCL, the
global batch split as ``cli.train --mesh-dp`` splits it (each rank's
``epoch_batches`` block of every global batch, padded to the global batch's
shapes, its edge dropout seeded per rank) and everything else as
``drivers/train.py``: packed text, seeded order, ``log_every`` 1, no
checkpoint. After backward one all-reduce averages the gradients
(``train.allreduce``); the quantizer's usage FIFO gathers every rank's
indices.

The benchmark's process is rank 0: it starts ranks 1.. as subprocesses of
this file (``python3 portbench/drivers/train_dp.py SPEC RANK``), joins the
group at ``tcp://localhost:<free port>`` with a 60 s timeout, and is the
rank that is measured and traced and whose set-up steps are checked.
Every rank stops where rank 0's window ends (one small all-reduce before
each draw of the window). Nothing hangs: a thread of rank 0 ends the run
non-zero within a second of a rank's failure, and each rank ends itself
when rank 0 is gone. ``backend`` "gloo" puts every rank on card 0 (the
one-card witness); on a CPU the ranks run on the CPU over gloo.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

CHECKOUT = Path(__file__).resolve().parent.parent.parent
if __name__ == "__main__" and str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import counts  # noqa: E402
from portbench.drivers.train import Feed  # noqa: E402
from portbench.drivers.train import Run as TrainRun  # noqa: E402
from portbench.reference.medtok import (  # noqa: E402
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
from portbench.weights import reference_copy, sub_seed  # noqa: E402

#: the process group's timeout: a group that cannot form, or a collective
#: that a dead rank never joins, raises after it
GROUP_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gen_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s dropout generator seed."""
    return sub_seed(seed, f"dropout{rank}")


class DpFeed(Feed):
    """``Feed`` whose window ends on every rank at the draw where rank 0's
    deadline passed: before each draw of the window the ranks take the
    largest of their stop flags (only rank 0 has a deadline)."""

    def __init__(self, batches, device, dp):
        super().__init__(batches, device)
        self.dp = dp
        self.window = False

    def __next__(self):
        if self.trace_at is not None and self.drawn == self.trace_at[1] and self.tracer:
            self.stop_trace()
        if self.window:
            late = self.deadline is not None and time.perf_counter() >= self.deadline
            if self.dp.all_reduce_max(int(late)):
                raise StopIteration
        if self.trace_at is not None and self.drawn == self.trace_at[0]:
            self.start_trace()
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.build_ms.append(1e3 * (time.perf_counter() - t0))
        self.drawn += 1
        return batch


class Run(TrainRun):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, *, rank: int = 0,
                 spec_dir: str | None = None):
        self.rank, self.world = rank, traffic["world"]
        self.backend = traffic["backend"] if torch.device(device).type == "cuda" else "gloo"
        if self.backend == "nccl":
            device = f"cuda:{rank}"
        elif torch.device(device).type == "cuda":
            device = "cuda:0"
        super().__init__(config, traffic, seed, device)
        self.gen_seed = gen_seed(seed, rank)
        self.spec_dir = spec_dir
        self.procs: list[subprocess.Popen] = []

    # ---------------------------------------------------------------- ranks --
    def _spawn(self) -> str:
        """Start ranks 1.. and a thread that ends this process if one of
        them fails; the group's address."""
        port = free_port()
        self.spec_dir = tempfile.mkdtemp(prefix="portbench_dp_")
        spec = {"config": self.config, "traffic": self.traffic, "seed": self.seed,
                "device": self.device.type, "port": port}
        path = os.path.join(self.spec_dir, "spec.json")
        Path(path).write_text(json.dumps(spec))
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        for r in range(1, self.world):
            with open(os.path.join(self.spec_dir, f"rank{r}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), path, str(r)],
                    cwd=CHECKOUT, env=env, stdout=log, stderr=subprocess.STDOUT))
        threading.Thread(target=self._watch, daemon=True).start()
        return f"tcp://localhost:{port}"

    def _watch(self) -> None:
        while True:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                # a rank ends with 0 only past the window's last collective
                if code not in (None, 0):
                    log = Path(self.spec_dir, f"rank{r}.log").read_text()[-3000:]
                    print(f"portbench: rank {r} exited {code}:\n{log}", file=sys.stderr,
                          flush=True)
                    self._kill()
                    os._exit(4)
            time.sleep(0.5)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def _join(self, address: str):
        import torch.distributed as dist

        from medtok_tpu_torch.parallel.mesh import initialize_distributed, warmup_collectives

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(self.backend, init_method=address, rank=self.rank,
                                world_size=self.world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        dp = initialize_distributed(self.device, dp=self.world)
        warmup_collectives(dp)
        return dp

    # ------------------------------------------------------------ the cell --
    def setup(self) -> None:
        from medtok_tpu_torch.config import MedTokConfig
        from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
        from medtok_tpu_torch.data.kg import KnowledgeGraph
        from medtok_tpu_torch.data.text import WordPieceTokenizer
        from medtok_tpu_torch.train.trainer import Trainer

        from portbench.datagen import make_corpus
        from portbench.weights import load_into, make_weights

        if self.rank == 0:
            address = self._spawn()
        else:
            spec = json.loads(Path(self.spec_dir, "spec.json").read_text())
            address = f"tcp://localhost:{spec['port']}"
        self.dp = dp = self._join(address)
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
        self.trainer = Trainer(cfg, device=self.device, log_fn=self._log, dp=dp)
        self.state = self.trainer.init_state()
        load_into(self.trainer.model, self.weights)
        self.state.generator.manual_seed(self.gen_seed)
        self.names = [n for n, p in self.trainer.model.named_parameters() if is_trainable(n)]

        def epochs():
            epoch = 0
            while True:
                yield from epoch_batches(dataset, batch_size=cfg.train.global_batch_size,
                                         seed=self.order_seed, epoch=epoch,
                                         process_index=dp.dp_index, process_count=dp.dp_size)
                epoch += 1

        self.feed = DpFeed(epochs(), self.device, dp)
        self.state = self.trainer.fit(self.state, self.feed, max_steps=t["check_steps"])
        self.set_up_steps = self.state.step

    def window(self, seconds: float, trace: bool) -> dict:
        self.feed.window = True
        return super().window(seconds, trace)

    def _ctx(self, feed, first_draw: int, step_ms) -> dict:
        """As the one-card driver's, the operations those of rank 0's own
        block of each traced global batch."""
        ctx = super()._ctx(feed, first_draw, step_ms)
        start, stop = feed.trace_at
        stop = min(stop, feed.drawn)
        batch = self.traffic["train"]["global_batch_size"]
        local = batch // self.world
        per_epoch = len(self.corpus) // batch
        codes = np.concatenate([
            epoch_codes(len(self.corpus), self.order_seed, i // per_epoch, batch,
                        i % per_epoch)[self.rank * local:(self.rank + 1) * local]
            for i in range(start, stop)])
        t, n, e = Inputs(self.corpus, self.config["data"], self.device).sizes(codes)
        ctx["flops"] = counts.model_flops(self.config["model"], t, n, e, train=True)
        return ctx

    def release(self) -> None:
        import torch.distributed as dist

        super().release()
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            try:
                p.wait(timeout=GROUP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
        if self.rank == 0:
            shutil.rmtree(self.spec_dir, ignore_errors=True)

    def check(self) -> dict[str, float]:
        """Rank 0's set-up steps judged by the reference run as DDP runs
        them (``reference_steps_dp``), with ``drivers/train.py``'s four
        numbers."""
        self.ref = reference_steps_dp(self.config, self.traffic, self.corpus, self.weights,
                                      self.order_seed, self.seed, self.device)
        beta1 = self.traffic["train"]["beta1"]
        return self.judge({
            "losses": self.losses[:self.traffic["check_steps"]],
            "grad": {n: m / (1.0 - beta1) for n, m in self.mu1.items()},
            "delta": {n: self.params_after[n] - self.weights[n].float() for n in self.names},
            "fifo": self.fifo1})

    def control(self) -> dict[str, float]:
        low = reference_steps_dp(self.config, self.traffic, self.corpus, self.weights,
                                 self.order_seed, self.seed, self.device, Precision("fp8"))
        fifo = []
        for group in FIFO_ORDER:
            fifo.append(torch.cat([low["sweeps"][n]["indices"] for n in group], -1).reshape(-1))
        return self.judge(dict(low, fifo=torch.cat(fifo)))


def reference_steps_dp(config: dict, traffic: dict, corpus, weights: dict, order_seed: int,
                       seed: int, device, precision=None) -> dict:
    """The checked steps as DDP runs them: each step's global batch cut into
    ``world`` contiguous shards, each shard's loss and gradient from its own
    edge dropout and dropout generator, the gradients averaged, then one
    clip and Adam step. Returns (the steps' losses, each the shards' mean;
    the first step's clipped gradient; the change over the steps; the first
    step's sweeps, the shards' rows in rank order as the FIFO gathers them,
    and the model that made them)."""
    tr = traffic["train"]
    world = traffic["world"]
    batch = tr["global_batch_size"]
    local = batch // world
    inputs = Inputs(corpus, config["data"], device)
    start = reference_copy(weights)
    params = {n: v.clone().requires_grad_(True) for n, v in start.items() if is_trainable(n)}
    frozen = {n: v for n, v in start.items() if not is_trainable(n)}
    adam = ClippedAdam(params, tr)
    gens = [torch.Generator(device=device).manual_seed(gen_seed(seed, r)) for r in range(world)]
    out = {"losses": []}
    for i in range(traffic["check_steps"]):
        codes = epoch_codes(len(corpus), order_seed, 0, batch, i)
        model = MedTok(config["model"], {**frozen, **params}, precision)
        total = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, shards = [], []
        shape = inputs.batch(codes)
        for r in range(world):
            b = padded_to(inputs.batch(codes[r * local:(r + 1) * local],
                                       aug_seed=aug_seed(order_seed, 0, i) * world + r), shape)
            loss, sweeps = train_loss(model, b, gens[r], tr)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for (n, _), g in zip(params.items(), grads):
                if g is not None:
                    total[n] += g
            losses.append(float(loss.detach()))
            shards.append({n: {"z_n": q["z_n"].detach(), "indices": q["indices"]}
                           for n, q in sweeps.items()})
        clipped = adam.clip({n: g / world for n, g in total.items()})
        if i == 0:
            cb = {"quantize.codebook": params["quantize.codebook"].detach().clone()}
            out.update(grad=clipped, model=MedTok(config["model"], cb, precision),
                       sweeps={n: {k: torch.cat([s[n][k] for s in shards])
                                   for k in ("z_n", "indices")} for n in shards[0]})
        adam.step(params, clipped)
        out["losses"].append(float(np.mean(losses)))
    out["delta"] = {n: p.detach() - start[n] for n, p in params.items()}
    return out


def padded_to(part, full):
    """A shard's batch at the global batch's text and node buckets, as
    ``epoch_batches`` pads each rank's block (the cross-attention's dropout
    masks are drawn in those shapes): ids and masks padded, the flat edge
    numbering b * Ln + i moved to the wider Ln."""
    Lt, Ln = full.input_ids.shape[1], full.node_ids.shape[1]
    lt, ln = part.input_ids.shape[1], part.node_ids.shape[1]

    def pad(x, width):
        return torch.nn.functional.pad(x, (0, width - x.shape[1]))

    def renumber(edges):
        return edges // ln * Ln + edges % ln

    return type(part)(pad(part.input_ids, Lt), pad(part.text_mask, Lt), pad(part.node_ids, Ln),
                      pad(part.node_mask, Ln), renumber(part.edges), renumber(part.edges_aug))


def rank_main(spec_path: str, rank: int) -> int:
    """Rank ``rank`` (1..) of a run rank 0 started: the same set-up, then
    the window until rank 0 ends it. Ends itself when rank 0 is gone. A
    traffic's ``fault_every_rank`` (a ``portbench.faults`` name, set by the
    one-card witness's readings alone) is planted here as rank 0 plants
    it."""
    parent = os.getppid()

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(5)
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()
    spec = json.loads(Path(spec_path).read_text())
    from medtok_tpu_torch.utils.platform import apply_platform_env

    apply_platform_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench.faults import FAULTS

    fault = spec["traffic"].get("fault_every_rank")
    run = Run(spec["config"], spec["traffic"], spec["seed"], spec["device"], rank=rank,
              spec_dir=os.path.dirname(spec_path))
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        run.setup()
        run.feed.window = True
        run.trainer.fit(run.state, run.feed)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
