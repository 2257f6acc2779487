"""EHR outcome-prediction CLI (counterpart of ``medtok_tpu/cli/ehr.py``).

    python -m medtok_tpu_torch.cli.ehr --dataset MIMIC_III --task readmission \\
        --ehr-root Dataset/EHR --med-codes codes.jsonl \\
        --embedding-path results/<exp>/embeddings_all.npy [--device cuda]

Parses {ehr-root}/{dataset}'s CSVs (no pandas), builds the task's samples
(cached as {ehr-root}/{dataset}/{dataset}_patient_{task}.pkl), labels and
features, splits 80/10/10 (stratified but for phenotype / drugrec; no
sklearn), trains ``EHRTrainer`` on the frozen MedTok table and evaluates the
best-validation model on the test split. Writes ``metrics.jsonl``,
``test_metrics.json`` and ``best_model/`` (``model.pt``, a torch state_dict,
and ``config.json``; ``EHRTrainer.load`` reads them back) under
``--save-result-path``; ``--hyper-search`` sweeps one hyperparameter at a
time and writes ``hyper_search.json``, best validation AUPRC first. The
vocabulary is a ``.jsonl`` (no pandas) or a ``.parquet`` (needs pandas).
Runs on CUDA unless ``--device`` names another device; without a GPU and
without ``--device`` it stops before reading anything. ``--wandb`` is
refused (an argparse error), as in ``cli.train``: the wandb mirror is not
ported.

Under ``torchrun --nproc-per-node N`` the training is data parallel over N
GPUs (NCCL; gloo with ``--device cpu``): ``--mesh-dp -1`` (the default)
means the world size and any other value than the world size raises; a
``--batch-size`` the world size does not divide is an argparse error (the
JAX CLI falls back to one device there; N processes would each train the
whole batch).
Rank 0 builds the task cache first and writes the outputs.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from medtok_tpu_torch.utils.platform import apply_platform_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default="MIMIC_III",
                   choices=["MIMIC_III", "MIMIC_IV", "EHRShot"])
    p.add_argument("--task", type=str, default="readmission",
                   choices=["mortality", "readmission", "lenofstay", "drugrec",
                            "phenotype", "new_disease"])
    p.add_argument("--ehr-root", type=str, default="Dataset/EHR")
    p.add_argument("--med-codes", type=str,
                   default="Dataset/medicalCode/all_codes_mappings.parquet")
    p.add_argument("--embedding-path", type=str, default="results/embeddings_all.npy")
    p.add_argument("--phenotype-index", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--input-dim", type=int, default=64)
    p.add_argument("--output-dim", type=int, default=64)
    p.add_argument("--max-visits", type=int, default=100)
    p.add_argument("--max-medical-code", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-result-path", type=str, default="task_results")
    p.add_argument("--mesh-dp", type=int, default=-1,
                   help="data-parallel ranks: -1 or torchrun's world size")
    p.add_argument("--flash", type=str, default="auto", choices=["auto", "on", "off"],
                   help="kernel K3 in the encoder (auto: on CUDA, the dense path on "
                        "the CPU)")
    p.add_argument("--wandb", action="store_true", help="not ported: refused")
    p.add_argument("--hyper-search", action="store_true",
                   help="coordinate hyperparameter sweep over dropout / num_layers / lr "
                        "for the chosen task")
    p.add_argument("--search-repeats", type=int, default=1,
                   help="repeats per grid point")
    p.add_argument("--search-grid", type=str, default=None,
                   help="JSON dict {hp_name: [values]} overriding the default sweep grid")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the run's summary: the stage wall times
    (``stages``), and either the best validation and test metrics, the
    number of classes and the test batches, or the grid's ``results``."""
    apply_platform_env()
    p = build_parser()
    args = p.parse_args(argv)
    if args.wandb:
        p.error("--wandb (the wandb mirror; metrics go to metrics.jsonl) is not ported to "
                "medtok_tpu_torch (ROADMAP Queue 1)")
    import torch.distributed as dist

    from medtok_tpu_torch.parallel.mesh import (
        check_mesh,
        initialize_distributed,
        warmup_collectives,
        world_size,
    )

    world = world_size()
    check_mesh(args.mesh_dp, 1, world)
    if args.batch_size % world:
        p.error(f"--batch-size {args.batch_size} is not divisible by the world size "
                f"{world}: each rank trains on its block of every batch")

    from medtok_tpu_torch import resolve_device

    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()   # a group the caller made stays
    dp = initialize_distributed(device)
    warmup_collectives(dp)
    rank = 0 if dp is None else dp.rank
    if dp is not None:
        device = dp.device

    from medtok_tpu_torch.ehr.parsers import EHRShotDataset, MIMIC3Dataset, MIMIC4Dataset
    from medtok_tpu_torch.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels
    from medtok_tpu_torch.ehr.train import (
        EHRTrainConfig,
        EHRTrainer,
        prepare_task_features,
        sample_weights,
        stratified_split,
    )
    from medtok_tpu_torch.utils.logging import MetricsLogger, create_logger

    logger = create_logger(args.save_result_path, process_index=rank)
    stages: dict[str, float] = {}
    clock = [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - clock[0]
        clock[0] = now
        logger.info(f"stage {name}: {stages[name]:.3f} s")

    root = Path(args.ehr_root) / args.dataset
    parser_cls = {"MIMIC_III": MIMIC3Dataset, "MIMIC_IV": MIMIC4Dataset,
                  "EHRShot": EHRShotDataset}[args.dataset]
    logger.info(f"Loading {args.dataset} from {root} on {device}")
    db = parser_cls(root)
    stage("parse_s")
    mapper = CodeMapper(args.med_codes)
    tasks = PatientEHRTasks(
        db.patients, mapper, dataset=args.dataset, phenotype_index=args.phenotype_index,
        cache_path=root / f"{args.dataset}_patient_{args.task}.pkl",
    )
    if rank:                  # rank 0 writes the task cache the others read
        dp.barrier()
    data = [d for d in tasks.build(args.task) if d and d[0]["label"] is not None]
    if dp is not None and rank == 0:
        dp.barrier()
    logger.info(f"Number of samples: {len(data)}")
    stage("tasks_s")

    labels, num_class = build_labels(data, args.task)
    feats, fz = prepare_task_features(
        data, labels, num_class, args.task, vocab_size=len(mapper),
        max_visits=args.max_visits, max_medical_code=args.max_medical_code,
    )
    tr, va, te = stratified_split(labels, args.task, seed=args.seed)
    w = sample_weights(labels, args.task)
    table = np.load(args.embedding_path)
    val_batches = [fz.collate([feats[i] for i in va[s:s + args.batch_size]])
                   for s in range(0, max(len(va) - args.batch_size + 1, 1), args.batch_size)]
    test_batches = [fz.collate([feats[i] for i in te[s:s + args.batch_size]])
                    for s in range(0, max(len(te) - args.batch_size + 1, 1), args.batch_size)]
    stage("featurize_s")

    def single_run(overrides: dict, metrics: MetricsLogger | None):
        """One train + eval run: (trainer, best state, best val, test)."""
        hp = {"lr": args.lr, "num_layers": args.num_layers, "dropout": args.dropout,
              **overrides}
        cfg = EHRTrainConfig(
            task=args.task, batch_size=args.batch_size, epochs=args.epochs,
            lr=hp["lr"], num_layers=hp["num_layers"], dropout=hp["dropout"],
            hidden_dim=args.hidden_dim, input_dim=args.input_dim,
            output_dim=args.output_dim, num_heads=args.num_heads,
            max_visits=args.max_visits, max_medical_code=args.max_medical_code,
            seed=hp.get("seed", args.seed),
            flash_attention={"auto": "auto", "on": True, "off": False}[args.flash],
        )
        trainer = EHRTrainer(cfg, table, num_class, device=device, dp=dp)
        epochs = []

        def log_fn(epoch, m):
            epochs.append(epoch)
            logger.info(f"epoch {epoch}: {m}")
            if metrics is not None:
                metrics.log(epoch, {"train/loss": m["loss"],
                                    **{f"val/{k}": v for k, v in m["val"].items()}})

        t0 = time.perf_counter()
        state, best = trainer.fit([feats[i] for i in tr], w[tr], val_batches, fz,
                                  log_fn=log_fn)
        fit_s = time.perf_counter() - t0
        samples = len(epochs) * (len(tr) // cfg.batch_size) * cfg.batch_size
        t0 = time.perf_counter()
        trainer.model.load_state_dict(state)  # evaluate the best-validation weights
        test = trainer.evaluate(test_batches)
        eval_s = time.perf_counter() - t0
        logger.info(f"fit: {len(epochs)} epochs, {samples} samples in {fit_s:.3f} s "
                    f"({samples / fit_s:.1f} samples/s, validation included); test "
                    f"evaluation {eval_s:.3f} s")
        if metrics is not None:
            metrics.log(args.epochs, {f"test/{k}": v for k, v in test.items()})
        stages["fit_s"] = stages.get("fit_s", 0.0) + fit_s
        stages["evaluate_s"] = stages.get("evaluate_s", 0.0) + eval_s
        stages["fit_samples"] = stages.get("fit_samples", 0) + samples
        return trainer, state, best, test

    out = Path(args.save_result_path)
    out.mkdir(parents=True, exist_ok=True)

    if args.hyper_search:
        # coordinate sweep: vary one hyperparameter at a time around the
        # CLI-given point
        grid = {"dropout": [0.1, 0.2, 0.3, 0.4, 0.5], "num_layers": [1, 2, 3, 4],
                "lr": [1e-4, 5e-4, 1e-3]}
        if args.search_grid:
            grid = json.loads(args.search_grid)
        results = []
        for hp_name, options in grid.items():
            logger.info(f"now searching for {hp_name}...")
            for hp_value in options:
                for rep in range(args.search_repeats):
                    _, _, best, test = single_run(
                        {hp_name: hp_value, "seed": args.seed + rep}, None)
                    logger.info(f"grid {hp_name}={hp_value} rep {rep}: {test}")
                    results.append({"hp": hp_name, "value": hp_value, "repeat": rep,
                                    "best_val": best, "test": test})
        results.sort(key=lambda r: -r["best_val"]["aupr"])
        if rank == 0:
            (out / "hyper_search.json").write_text(json.dumps(
                {"task": args.task, "dataset": args.dataset, "results": results},
                indent=2) + "\n")
        logger.info(f"Best grid point: {results[0]}")
        finish(dp, owns_group)
        return {"stages": stages, "results": results}

    metrics = MetricsLogger(out if rank == 0 else None)
    try:
        trainer, state, best, test = single_run({}, metrics)
    finally:
        metrics.close()
    logger.info(f"Best val: {best}")
    logger.info(f"Test: {test}")
    if rank == 0:
        trainer.save(out / "best_model", state)
        (out / "test_metrics.json").write_text(json.dumps(
            {"task": args.task, "dataset": args.dataset, "best_val": best, "test": test},
            indent=2) + "\n")
        logger.info(f"Saved best model + metrics under {out}")
    finish(dp, owns_group)
    return {"stages": stages, "best_val": best, "test": test, "num_class": num_class,
            "test_batches": test_batches}


def finish(dp, owns_group: bool) -> None:
    """Wait for rank 0's writes; leave the group this run joined."""
    if dp is None:
        return
    import torch.distributed as dist

    dp.barrier()
    if owns_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
