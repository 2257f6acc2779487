"""One rank of the data- and tensor-parallel tests
(``tests/test_torch_dp_*.py``, ``tests/test_torch_tp_*.py``): it joins a
gloo group through a file under the test's tmp_path, lays the spec's
(dp, tp) mesh over it (``spec["tp"]``, default 1), runs one task of the
port on the CPU and pickles what it saw for the test to hold against the
JAX package and against the other ranks. It imports neither JAX nor the
JAX package.

    python -m tests.torch_dp_ranks TASK RANK WORLD INIT_FILE SPEC OUT

``spawn_ranks`` starts WORLD of them and waits, each join and the whole run
bounded by TIMEOUT_S.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def spawn_ranks(task: str, world: int, tmp: Path, spec: dict) -> list[dict]:
    """Run ``task`` in ``world`` gloo ranks; every rank's pickled result,
    in rank order. A rank that fails or outlives TIMEOUT_S fails the test
    with its output."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / "spec.pkl"
    spec_path.write_bytes(pickle.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_ranks", task, str(r), str(world),
         str(tmp / "group"), str(spec_path), str(tmp / f"rank{r}.pkl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def local_block(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a global batch (a NamedTuple of
    numpy arrays): rows of the [B, ...] fields, and of the flat per-graph
    edge fields [B * Epg]."""
    B = batch[0].shape[0]
    lb = B // world
    out = []
    for name, a in zip(batch._fields, batch):
        per = a.shape[0] // B if name.startswith("edge") else 1
        out.append(a[rank * lb * per:(rank + 1) * lb * per])
    return type(batch)(*out)


def snapshot(model) -> dict[str, torch.Tensor]:
    """Every parameter and buffer (the state_dict leaves the FIFO and the
    EMA codebook out), cloned."""
    out = {f"param {n}": t.detach().clone() for n, t in model.state_dict().items()}
    out.update({f"buffer {n}": t.detach().clone() for n, t in model.named_buffers()})
    return out


def task_train(dp, spec: dict) -> dict:
    """Tokenizer steps through ``Trainer.fit``, one global batch at a time
    (this rank's dp block): each step's state before, the metrics, the
    averaged gradients Adam received, the state after, the four paths'
    tokens; then the automatic row budget of the first batch's block and
    the k-means init's EMA codebook and cluster sizes."""
    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.data.types import CodeBatch
    from medtok_tpu_torch.train import trainer as tr

    cfg = MedTokConfig.from_dict(spec["cfg"])
    logged: list[dict] = []
    trainer = tr.Trainer(cfg, device="cpu", dp=dp, log_fn=lambda s, m: logged.append(m))
    state = trainer.init_state(params=spec["variables"])
    grads: list[list[torch.Tensor]] = []
    step = tr.ClippedAdam.step

    def spy(self, params, gs, st):
        grads.append([g.clone() for g in gs])
        return step(self, params, gs, st)

    tr.ClippedAdam.step = spy
    tokens: list[np.ndarray] = []
    forward_train = trainer.model.forward_train

    def spy_forward(*a, **kw):
        out = forward_train(*a, **kw)
        tokens.append(torch.stack([out[f"{p}_tokens"] for p in
                                   ("text", "graph", "shared_text", "shared_graph")], 1).numpy())
        return out

    trainer.model.forward_train = spy_forward
    names = [n for n, _ in tr.trainable_parameters(trainer.model)]
    steps = []
    for b in spec["batches"]:
        local = local_block(CodeBatch(*b), dp.dp_index, dp.dp_size)
        before = snapshot(trainer.model)
        packed = trainer.pack(local)
        state = trainer.fit(state, [local])
        steps.append(dict(before=before, after=snapshot(trainer.model), metrics=logged[-1],
                          grads=dict(zip(names, grads[-1])), local=local, packed=packed,
                          mu=[m.clone() for m in state.opt_state.mu], tokens=tokens[-1]))
    first = local_block(CodeBatch(*spec["batches"][0]), dp.dp_index, dp.dp_size)
    budget = tr.packed_rows_budget(np.asarray(first.attention_mask),
                                   cfg.train.packed_row_len, dp)
    # the k-means init over the ranks' blocks of the first batch, from the
    # initial rows the test gives
    tr.kmeans_init_codebook(trainer.model, state, [first], dp=dp,
                            init_idx=torch.from_numpy(spec["kmeans_init_idx"]))
    q = trainer.model.quantize
    return dict(steps=steps, budget=budget, own=tr.packed_rows_budget(
        np.asarray(first.attention_mask), cfg.train.packed_row_len),
        kmeans=(q.ema_codebook.clone(), q.ema_cluster.clone()))


def task_ehr(dp, spec: dict) -> dict:
    """EHR Adam steps on this rank's blocks (loss, averaged gradients and
    parameters after each), then a short ``fit`` from fresh weights."""
    from medtok_tpu_torch.ehr import train
    from medtok_tpu_torch.ehr.dataset import EHRBatch

    cfg = train.EHRTrainConfig(**spec["cfg"])
    t = train.EHRTrainer(cfg, spec["table"], spec["num_class"], device="cpu", dp=dp)
    t.model.load_state_dict(spec["params"], strict=True)
    steps = []
    for b in spec["batches"]:
        loss, _ = t.train_step(local_block(EHRBatch(*b), dp.rank, dp.world))
        steps.append(dict(loss=float(loss),
                          grads={n: p.grad.clone() for n, p in t.model.named_parameters()},
                          params=snapshot(t.model)))
    fit_state, best = t.fit(spec["fit_feats"], spec["fit_weights"],
                            [EHRBatch(*b) for b in spec["val"]], spec["featurizer"])
    return dict(steps=steps, fit_state=fit_state, best=best, fit_steps=t.step)


def task_cli(dp, spec: dict) -> dict:
    """``cli.train.main`` to step 2, then resumed with --workdir to step 3:
    each rank's state as it saved a step and as it restored one, and the
    ranks that called ``CheckpointManager.save``; then ``cli.ehr.main``
    (its validation and test metrics)."""
    from medtok_tpu_torch.cli import ehr as ehr_cli
    from medtok_tpu_torch.cli import train as train_cli
    from medtok_tpu_torch.train.trainer import Trainer
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager

    seen: dict = {"saves": [], "states": {}}
    save, init_state, ckpt_save = Trainer.save, Trainer.init_state, CheckpointManager.save

    def record(label, trainer, state):
        seen["states"][label] = {**snapshot(trainer.model),
                                 "generator": state.generator.get_state(),
                                 "mu": [m.clone() for m in state.opt_state.mu],
                                 "step": state.step, "pack_rows": trainer.pack_rows}

    def spy_save(self, state):
        record(f"saved {state.step}", self, state)
        return save(self, state)

    def spy_init(self, params=None):
        state = init_state(self, params)
        record(f"started {state.step}", self, state)
        return state

    def spy_ckpt(self, state, **kw):
        seen["saves"].append((dp.rank, state.step))
        return ckpt_save(self, state, **kw)

    Trainer.save, Trainer.init_state, CheckpointManager.save = spy_save, spy_init, spy_ckpt
    workdir = train_cli.main([*spec["argv"], "--max-steps", "2"])
    again = train_cli.main([*spec["argv"], "--workdir", str(workdir), "--max-steps", "3"])
    ehr = ehr_cli.main(spec["ehr_argv"])
    return dict(workdir=str(workdir), again=str(again), ehr={k: ehr[k] for k in (
        "best_val", "test", "num_class")}, **seen)


def task_tp_sweep(world, spec: dict) -> dict:
    """``ops.vq.distance_topk_tp`` on each mesh of ``spec["tps"]`` laid over
    the world, for each case (z_n, e_n, k, region): values and global ids;
    then ``soft_topk_quantize`` of each case through the tp route (its
    region by name) and its gradients."""
    from medtok_tpu_torch.ops import vq
    from medtok_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for tp in spec["tps"]:
        mesh = make_mesh(world, -1, tp)
        sweeps = []
        for z, e, k, region in spec["cases"]:
            v, i = vq.distance_topk_tp(torch.from_numpy(z), torch.from_numpy(e), k, mesh,
                                       region=region)
            sweeps.append((v.numpy(), i.numpy()))
        quantized = []
        for z, e, k, name in spec["quantize"]:
            zt = torch.from_numpy(z).requires_grad_()
            et = torch.from_numpy(e).requires_grad_()
            q = vq.soft_topk_quantize(zt, et, k=k, train=True, region=name, mesh=mesh)
            (q.z_q_raw.square().sum() + q.vq_loss + q.commit_loss).backward()
            quantized.append(dict(indices=q.indices.numpy(), weights=q.weights.detach().numpy(),
                                  z_q=q.z_q.detach().numpy(), dz=zt.grad.numpy(),
                                  de=et.grad.numpy()))
        out[tp] = dict(sweeps=sweeps, quantize=quantized, tp_index=mesh.tp_index)
    return out


def task_tp_qa(world, spec: dict) -> dict:
    """QA finetuning (``QAFinetuner.fit``) on each mesh of ``spec["meshes"]``
    laid over the world, from a one-device state (the LLM state_dict and
    the projector, by LoRA targets): the losses, every trainable tensor gathered to the
    one-device layout, the replicated ones as this rank holds them, and
    the greedy tokens of ``generate`` on the spec's prompts."""
    from medtok_tpu_torch.parallel.mesh import make_mesh
    from medtok_tpu_torch.qa import finetune
    from medtok_tpu_torch.qa.llama import TINY_LLAMA, generate
    from medtok_tpu_torch.qa.sharding import gather_param

    out = {}
    for (dp_size, tp), cfg_kw in spec["meshes"]:
        mesh = make_mesh(world, dp_size, tp)
        cfg = finetune.QAFinetuneConfig(**cfg_kw, mesh_dp=dp_size, mesh_tp=tp)
        ft = finetune.QAFinetuner(TINY_LLAMA, spec["table"], cfg, dp=mesh)
        targets = cfg_kw.get("lora_targets", ("q_proj", "v_proj"))
        ft.init_params(spec["llm"][targets])
        ft.soft_prompt.projector.load_state_dict(spec["projector"][targets])
        losses: list[float] = []
        ft.fit(spec["rows"], log_fn=lambda s, loss: losses.append(loss))
        trained = {n: gather_param(n.removeprefix("llm."), p.detach(), ft.model.mesh,
                                   ft.llm_cfg)
                   for n, p in ft.named_parameters() if p.requires_grad}
        replicated = {n: p.detach().clone() for n, p in ft.named_parameters()
                      if p.requires_grad and (not n.startswith("llm.") or
                                              trained[n].shape == p.shape)}
        embeds, mask = (torch.from_numpy(a) for a in spec["prompt"])
        toks = generate(ft.model, embeds, mask, max_new_tokens=spec["new_tokens"],
                        temperature=0.0, device="cpu")
        out[(dp_size, tp)] = dict(losses=losses, trained=trained, replicated=replicated,
                                  tokens=toks)
    return out


def task_tp_cli(world, spec: dict) -> dict:
    """``cli.train`` on the spec's mesh to step 2, resumed with --workdir to
    step 3 (each rank's state as it saved each step), then ``cli.qa
    finetune`` (its losses) and ``cli.qa eval`` (its predictions), each on
    its argv's mesh."""
    from medtok_tpu_torch.cli import qa as qa_cli
    from medtok_tpu_torch.cli import train as train_cli
    from medtok_tpu_torch.train.trainer import Trainer

    seen: dict = {}
    save = Trainer.save

    def spy_save(self, state):
        seen[state.step] = {**snapshot(self.model), "generator": state.generator.get_state(),
                            "mu": [m.clone() for m in state.opt_state.mu]}
        return save(self, state)

    Trainer.save = spy_save
    workdir = train_cli.main([*spec["argv"], "--max-steps", "2"])
    again = train_cli.main([*spec["argv"], "--workdir", str(workdir), "--max-steps", "3"])
    qa = qa_cli.main(spec["qa_argv"])
    qa_eval = qa_cli.main(spec["qa_eval_argv"])
    return dict(workdir=str(workdir), again=str(again), saved=seen, qa_losses=qa["losses"],
                qa_eval=qa_eval)


def task_export(dp, spec: dict) -> dict:
    """``export_all(dp=)`` on each vocabulary of ``spec["codes"]``, unpacked
    (batches of ``spec["batch_size"]``) and packed (the full vocabulary in
    ``spec["pack"]``'s small rows): the arrays and the steps this rank ran;
    then ``cli.export`` with ``spec["cli_argv"]`` into ``spec["cli_out"]``
    and the output directories this rank saved to."""
    from medtok_tpu_torch import export as export_mod
    from medtok_tpu_torch.cli import export as export_cli
    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.convert import load_params
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    cfg = MedTokConfig.load(spec["config"])
    model = load_params(MultimodalTokenizer(cfg.model), spec["params"])
    kg = KnowledgeGraph.from_csv(spec["kg"])
    tokenizer = WordPieceTokenizer.from_vocab_file(spec["vocab"])
    steps = []
    own_steps = export_mod._own_steps

    def spy_steps(all_steps, dp):
        mine = own_steps(all_steps, dp)
        steps.append(len(mine))
        return mine

    saves = []
    save = export_mod._save

    def spy_save(arrays, out_dir):
        if out_dir is not None:
            saves.append(str(out_dir))
        return save(arrays, out_dir)

    export_mod._own_steps, export_mod._save = spy_steps, spy_save
    out: dict = {}
    for name, codes in spec["codes"].items():
        ds = MedCodeDataset.from_path(kg, codes, tokenizer, cfg=cfg.data)
        arrays = export_mod.export_all(model, ds, batch_size=spec["batch_size"],
                                       device="cpu", dp=dp)
        out[(name, False)] = dict(arrays=arrays, steps=steps[-1])
        arrays = export_mod.export_all_packed(model, ds, device="cpu", dp=dp,
                                              **(spec["pack"] if name == "full" else {}))
        out[(name, True)] = dict(arrays=arrays, steps=steps[-1])
    out["cli"] = export_cli.main([*spec["cli_argv"], "--out-dir", spec["cli_out"]])
    out["saves"] = saves
    return out


def task_norm_ema(dp, spec: dict) -> dict:
    """``ops.ema.norm_ema_quantize`` with ``dp=`` on this rank's block of
    the spec's rows (train on and off, from the spec's state): the rank's
    indices, loss, new weight and both cluster sizes."""
    from medtok_tpu_torch.ops.ema import EmbeddingEMAState, norm_ema_quantize

    z = torch.from_numpy(np.array_split(spec["z"], dp.world)[dp.rank])
    state = EmbeddingEMAState(*(torch.from_numpy(np.array(x)) for x in spec["state"]))
    out = {}
    for train in (True, False):
        o = norm_ema_quantize(z, state, torch.from_numpy(spec["cluster"]), train=train, dp=dp)
        out[train] = {"indices": o.indices.numpy(), "loss": float(o.loss),
                      "weight": o.state.weight.numpy(), "ema_cluster": o.cluster_size.numpy(),
                      "state_cluster": o.state.cluster_size.numpy()}
    return out


def task_zero(dp, spec: dict) -> dict:
    """One Adam step (``foreach=False``) of the JAX ZeRO test's loss on
    ``spec``'s tiny parameters, replicated and on stage-3 DTensors
    (``utils.zero.apply_zero``): both steps' full parameters, each leaf's
    placement and this rank's shard shape."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from medtok_tpu_torch.utils.zero import apply_zero

    params = {k: torch.from_numpy(v) for k, v in spec["params"].items()}
    x, y = torch.from_numpy(spec["x"]), torch.from_numpy(spec["y"])

    def step(leaves, mesh=None):
        ps = {k: torch.nn.Parameter(v) for k, v in leaves.items()}
        opt = torch.optim.Adam(list(ps.values()), lr=1e-2, foreach=False)
        xx, yy = x, y
        if mesh is not None:
            xx, yy = (distribute_tensor(t, mesh, [Replicate()]) for t in (x, y))
        ((xx @ ps["w"] + ps["b"] + ps["odd"].sum() - yy) ** 2).mean().backward()
        opt.step()
        return {k: (v.full_tensor() if mesh is not None else v).detach().numpy()
                for k, v in ps.items()}

    p3 = apply_zero(3, dp, params)
    return {"replicated": step({k: v.clone() for k, v in params.items()}),
            "stage3": step(p3, p3["w"].device_mesh),
            "placements": {k: str(v.placements[0]) for k, v in p3.items()},
            "local_shapes": {k: tuple(v.to_local().shape) for k, v in p3.items()}}


TASKS = {"norm_ema": task_norm_ema, "zero": task_zero, "export": task_export, "train": task_train, "ehr": task_ehr, "cli": task_cli, "tp_sweep": task_tp_sweep,
         "tp_qa": task_tp_qa, "tp_cli": task_tp_cli}


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    from medtok_tpu_torch.parallel.mesh import initialize_distributed

    task, rank, world, init_file, spec_path, out = argv
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=int(rank),
                            world_size=int(world),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    spec = pickle.loads(Path(spec_path).read_bytes())
    dp = initialize_distributed("cpu", tp=spec.get("tp", 1))
    result = TASKS[task](dp, spec)
    Path(out).write_bytes(pickle.dumps(result))
    dp.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
