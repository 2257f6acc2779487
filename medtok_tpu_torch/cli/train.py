"""Tokenizer training CLI (counterpart of ``medtok_tpu/cli/train.py``).

    python -m medtok_tpu_torch.cli.train --kg-path Dataset/primeKG/ \
        --med-codes-pkg-map-path codes.jsonl --text-vocab vocab.txt \
        --results-dir results/ [--device cuda]
    torchrun --nproc-per-node 8 -m medtok_tpu_torch.cli.train ...same flags...
    torchrun --nproc-per-node 4 -m medtok_tpu_torch.cli.train ... --mesh-dp 2 --mesh-tp 2

The flags are the JAX CLI's, and so is the config they resolve to
(``config_from_args``), frozen to ``<experiment>/args.json``; checkpoints
rotate under ``<experiment>/checkpoints``. ``--workdir`` reuses an
experiment directory and resumes from its latest checkpoint, its stored
config winning over the flags. The vocabulary is a ``.parquet`` (needs
pandas) or a ``.jsonl`` copy of its columns (``data/dataset.py``); the KG
is read without pandas. Runs on CUDA unless ``--device`` names another
device; without a GPU and without ``--device`` it stops before loading
anything. ``--graph-model-name GAT`` trains the GAT encoder, ``--kmeans``
the EMA codebook (set by cosine k-means over the first batch's shared
features at step 0; a resumed run keeps its checkpointed codebook) and
``--codebook-revival`` its dead-code revival, ``--text-dropout-in-train``
BERT dropout (``--packed-text`` auto then goes off).

Under ``torchrun`` (``python -m torch.distributed.run``) the run takes a
(dp, tp) mesh of the world's ranks, one process a GPU over NCCL (gloo with
``--device cpu``): ``--mesh-tp T`` ranks split each codebook sweep's rows,
and ``--mesh-dp`` (-1, the default, means world / T) blocks split each
global batch; a world that T does not divide, or a dp x tp other than the
world size, is refused at parse time. Each dp block takes its block of
every global batch (``--global-batch-size`` stays the global batch), and
the tp ranks of a block the same one; rank 0 writes args.json (the mesh in
it), the log, ``metrics.jsonl`` and the checkpoints, and the k-means init
clusters the whole first batch. Without the launcher ``--mesh-dp`` or
``--mesh-tp`` above 1 is refused, naming the torchrun launch it needs.
``--multihost`` is the same launcher across hosts (torchrun's ``--nnodes``
/ ``--rdzv-endpoint``) and needs its environment. ``--wandb`` is refused at
parse time.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from medtok_tpu_torch.utils.platform import apply_platform_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kg-path", type=str, default="Dataset/primeKG/")
    p.add_argument("--med-codes-pkg-map-path", type=str,
                   default="Dataset/medicalCode/all_codes_mappings.parquet",
                   help="the code vocabulary: .parquet or .jsonl")
    p.add_argument("--text-vocab", type=str, required=True,
                   help="WordPiece vocab.txt (bert-base-uncased)")
    p.add_argument("--bert-checkpoint", type=str, default=None,
                   help="HF bert-base-uncased PyTorch state_dict to load into the "
                        "frozen text encoder")
    p.add_argument("--results-dir", type=str, default="results")
    p.add_argument("--graph-model-name", type=str, default="GCN", choices=["GCN", "GAT"])
    # text-encoder shape (defaults = bert-base-uncased)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--text-hidden", type=int, default=768)
    p.add_argument("--text-heads", type=int, default=12)
    p.add_argument("--text-intermediate", type=int, default=3072)
    p.add_argument("--text-vocab-size", type=int, default=30522)
    p.add_argument("--kg-num-nodes", type=int, default=130000)
    p.add_argument("--graph-in-channels", type=int, default=64)
    p.add_argument("--graph-hidden-channels", type=int, default=128)
    p.add_argument("--graph-out-channels", type=int, default=64)
    p.add_argument("--codebook-size", type=int, default=21000)
    p.add_argument("--codebook-embed-dim", type=int, default=64)
    p.add_argument("--commit-loss-beta", type=float, default=0.25)
    p.add_argument("--entropy-loss-ratio", type=float, default=0.0)
    p.add_argument("--kmeans", action="store_true",
                   help="kmeans-init + norm-EMA codebook")
    p.add_argument("--codebook-revival", action="store_true",
                   help="dead-code revival for the EMA codebook; requires --kmeans")
    p.add_argument("--shared-loss-beta", type=float, default=0.1)
    p.add_argument("--specific-loss-lamb", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--global-batch-size", type=int, default=1024)
    p.add_argument("--global-seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--max-checkpoints", type=int, default=2)
    p.add_argument("--mixed-precision", type=str, default="bf16", choices=["none", "bf16"])
    p.add_argument("--ema", action="store_true")
    p.add_argument("--mesh-dp", type=int, default=-1,
                   help="data-parallel blocks: -1 (world / mesh-tp) or world / mesh-tp")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel ranks of the codebook sweep; divides the world")
    p.add_argument("--wandb", action="store_true", help="not ported: refused")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="a torchrun launch across hosts (needs its environment)")
    p.add_argument("--packed-text", type=str, default="auto", choices=["auto", "on", "off"],
                   help="sequence-packed frozen-BERT forward in the train step (auto = "
                        "on unless --text-dropout-in-train is set)")
    p.add_argument("--text-dropout-in-train", action="store_true",
                   help="run the frozen BERT with dropout in training (unpacked; "
                        "incompatible with --packed-text on)")
    p.add_argument("--edge-dropout-p", type=float, default=0.1,
                   help="graph-augmentation edge dropout")
    p.add_argument("--workdir", type=str, default=None,
                   help="reuse an existing experiment dir and resume from its latest "
                        "checkpoint; default: a new timestamped dir")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, checked against the launcher's world size; those that
    select code the port lacks are refused (an argparse error, exit code
    2)."""
    from medtok_tpu_torch.parallel.mesh import check_mesh, launched, world_size

    p = build_parser()
    args = p.parse_args(argv)
    if args.codebook_revival and not args.kmeans:
        p.error("--codebook-revival requires --kmeans")
    if args.wandb:
        p.error("--wandb (the wandb mirror; metrics go to metrics.jsonl) is not ported to "
                "medtok_tpu_torch (ROADMAP Queue 1)")
    world = world_size()
    try:
        check_mesh(args.mesh_dp, args.mesh_tp, world)
    except ValueError as e:
        p.error(f"--mesh-dp {args.mesh_dp} --mesh-tp {args.mesh_tp}: {e}")
    blocks = world // args.mesh_tp
    if args.global_batch_size % blocks:
        p.error(f"--global-batch-size {args.global_batch_size} is not divisible by the "
                f"world size {world}" + (f" / mesh-tp {args.mesh_tp} = {blocks} data-parallel "
                                         f"blocks" if args.mesh_tp > 1 else ""))
    if args.multihost and not launched():
        p.error("--multihost needs torchrun's environment (RANK, WORLD_SIZE, "
                "MASTER_ADDR, MASTER_PORT): launch with `torchrun --nnodes ...`")
    return args


def config_from_args(args):
    """The MedTokConfig of the flags, field for field the JAX CLI's."""
    from medtok_tpu_torch.config import (
        DataConfig,
        GraphEncoderConfig,
        MedTokConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
        TrainConfig,
    )

    if args.packed_text == "on" and args.text_dropout_in_train:
        raise SystemExit("--packed-text on is incompatible with --text-dropout-in-train: "
                         "dropout noise would leak across packed segments")
    return MedTokConfig(
        model=ModelConfig(
            text=TextEncoderConfig(
                vocab_size=args.text_vocab_size, hidden_size=args.text_hidden,
                num_layers=args.text_layers, num_heads=args.text_heads,
                intermediate_size=args.text_intermediate,
            ),
            graph=GraphEncoderConfig(
                num_nodes=args.kg_num_nodes, model_name=args.graph_model_name,
                in_channels=args.graph_in_channels,
                hidden_channels=args.graph_hidden_channels,
                out_channels=args.graph_out_channels,
            ),
            quantizer=QuantizerConfig(
                codebook_size=args.codebook_size,
                codebook_embed_dim=args.codebook_embed_dim,
                commit_loss_beta=args.commit_loss_beta,
                entropy_loss_ratio=args.entropy_loss_ratio,
                use_kmeans=args.kmeans, codebook_revival=args.codebook_revival,
            ),
            compute_dtype="bfloat16" if args.mixed_precision == "bf16" else "float32",
            text_dropout_in_train=args.text_dropout_in_train,
        ),
        data=DataConfig(
            kg_path=args.kg_path, med_codes_pkg_map_path=args.med_codes_pkg_map_path,
            text_vocab_path=args.text_vocab, edge_dropout_p=args.edge_dropout_p,
        ),
        train=TrainConfig(
            epochs=args.epochs, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
            max_grad_norm=args.max_grad_norm, global_batch_size=args.global_batch_size,
            global_seed=args.global_seed, log_every=args.log_every,
            ckpt_every=args.ckpt_every, max_checkpoints=args.max_checkpoints,
            mixed_precision=args.mixed_precision, ema=args.ema,
            results_dir=args.results_dir, mesh_dp=args.mesh_dp, mesh_tp=args.mesh_tp,
            shared_loss_beta=args.shared_loss_beta,
            specific_loss_lamb=args.specific_loss_lamb,
            packed_text=args.packed_text == "on" or (
                args.packed_text == "auto" and not args.text_dropout_in_train),
        ),
    )


def main(argv=None) -> Path:
    """Train; returns the experiment directory."""
    apply_platform_env()
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch import resolve_device

    from medtok_tpu_torch.parallel.mesh import initialize_distributed, warmup_collectives
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = config_from_args(args)
    if args.workdir and (Path(args.workdir) / "args.json").exists():
        # the config-freezing contract: the stored config (its mesh too) wins on resume
        cfg = CheckpointManager.load_config(Path(args.workdir))
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()   # a group the caller made stays
    t0 = time.perf_counter()
    dp = initialize_distributed(device, dp=cfg.train.mesh_dp, tp=cfg.train.mesh_tp)
    init_s = time.perf_counter() - t0
    warmup_collectives(dp)
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    if dp is not None:
        device = dp.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.models.bert import convert_hf_bert
    from medtok_tpu_torch.train.trainer import Trainer, kmeans_init_codebook
    from medtok_tpu_torch.utils.logging import MetricsLogger, create_logger

    if args.workdir:
        workdir = Path(args.workdir)
    else:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        workdir = Path(args.results_dir) / f"{stamp}-{args.graph_model_name}"
        if dp is not None:   # rank 0's clock names the directory
            workdir = dp.broadcast_object(workdir)
    logger = create_logger(workdir, process_index=rank)
    logger.info(f"Experiment directory created at {workdir}")
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if dp is not None:
        logger.info(f"data parallel: {world} ranks over {dp.backend} as a mesh of dp "
                    f"{dp.dp_size} x tp {dp.tp_size}, the process group "
                    f"joined in {init_s:.3f} s, warmed up in "
                    f"{time.perf_counter() - t0 - init_s:.3f} s")

    dataset = MedCodeDataset.from_path(
        KnowledgeGraph.from_csv(cfg.data.kg_path), cfg.data.med_codes_pkg_map_path,
        WordPieceTokenizer.from_vocab_file(args.text_vocab), cfg=cfg.data)
    logger.info(f"Dataset contains {len(dataset):,} medical codes")

    metrics_logger = MetricsLogger(workdir if rank == 0 else None)

    def log_fn(step, m):
        metrics_logger.log(step, m)
        logger.info(f"(step={step:07d}) Train Loss: {m.get('loss', float('nan')):.4f}, "
                    f"Train Steps/Sec: {m.get('steps_per_sec', 0):.2f}")

    trainer = Trainer(cfg, device=device, workdir=workdir, log_fn=log_fn, dp=dp)
    state = trainer.init_state()
    if state.step:
        logger.info(f"Resumed from the checkpoint at step {state.step}")
    if args.bert_checkpoint:
        # before anything reads the text encoder
        logger.info(f"Loading BERT weights from {args.bert_checkpoint}")
        sd = torch.load(args.bert_checkpoint, map_location="cpu", weights_only=True)
        trainer.model.text_model.load_state_dict(convert_hf_bert(sd, cfg.model.text))
    t = cfg.train
    # the dp blocks split each global batch; the tp ranks of a block read the same rows
    shard = ({} if dp is None else
             dict(process_index=dp.dp_index, process_count=dp.dp_size))
    if cfg.model.quantizer.use_kmeans and state.step == 0:
        # after the BERT weights: the init clusters the text encoder's
        # features of the whole first batch
        first = next(iter(epoch_batches(dataset, batch_size=t.global_batch_size,
                                        seed=t.global_seed, epoch=0, **shard)))
        state = kmeans_init_codebook(trainer.model, state, [first], dp=dp)
        logger.info("kmeans codebook init done")

    steps_per_epoch = len(dataset) // t.global_batch_size
    start_epoch = state.step // max(steps_per_epoch, 1)
    logger.info(f"Training for {t.epochs} epochs from epoch {start_epoch}...")
    for epoch in range(start_epoch, t.epochs):
        logger.info(f"Beginning epoch {epoch}...")
        batches = epoch_batches(dataset, batch_size=t.global_batch_size,
                                seed=t.global_seed, epoch=epoch, **shard)
        state = trainer.fit(state, batches, max_steps=args.max_steps)
        if args.max_steps is not None and state.step >= args.max_steps:
            break
    trainer.save(state)
    metrics_logger.close()
    logger.info("Done!")
    if dp is not None and owns_group:
        dist.destroy_process_group()
    return workdir


if __name__ == "__main__":
    main()
