"""Tokenizer training CLI (counterpart of ``medtok_tpu/cli/train.py``).

    python -m medtok_tpu_torch.cli.train --kg-path Dataset/primeKG/ \
        --med-codes-pkg-map-path codes.jsonl --text-vocab vocab.txt \
        --results-dir results/ [--device cuda]

The flags are the JAX CLI's, and so is the config they resolve to
(``config_from_args``), frozen to ``<experiment>/args.json``; checkpoints
rotate under ``<experiment>/checkpoints``. ``--workdir`` reuses an
experiment directory and resumes from its latest checkpoint, its stored
config winning over the flags. The vocabulary is a ``.parquet`` (needs
pandas) or a ``.jsonl`` copy of its columns (``data/dataset.py``); the KG
is read without pandas. Runs on CUDA unless ``--device`` names another
device; without a GPU and without ``--device`` it stops before loading
anything. Flags that select code the port does not have (the kmeans
codebook, BERT dropout in training, a device mesh, wandb, multi-host
bootstrapping, the GAT encoder) are refused at parse time.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


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
                   help="kmeans-init + norm-EMA codebook (not ported: refused)")
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
    p.add_argument("--mesh-dp", type=int, default=-1)
    p.add_argument("--mesh-tp", type=int, default=1)
    p.add_argument("--wandb", action="store_true", help="not ported: refused")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--multihost", action="store_true", help="not ported: refused")
    p.add_argument("--packed-text", type=str, default="auto", choices=["auto", "on", "off"],
                   help="sequence-packed frozen-BERT forward in the train step (auto = "
                        "on unless --text-dropout-in-train is set)")
    p.add_argument("--text-dropout-in-train", action="store_true",
                   help="BERT dropout in training (not ported: refused)")
    p.add_argument("--edge-dropout-p", type=float, default=0.1,
                   help="graph-augmentation edge dropout")
    p.add_argument("--workdir", type=str, default=None,
                   help="reuse an existing experiment dir and resume from its latest "
                        "checkpoint; default: a new timestamped dir")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with those that select code the port lacks refused (an
    argparse error, exit code 2)."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.codebook_revival and not args.kmeans:
        p.error("--codebook-revival requires --kmeans")
    refused = [(args.kmeans, "--kmeans (the EMA codebook and its kmeans init)"),
               (args.text_dropout_in_train, "--text-dropout-in-train (BERT dropout)"),
               (args.mesh_dp > 1 or args.mesh_tp > 1,
                "--mesh-dp / --mesh-tp above 1 (data-parallel training)"),
               (args.wandb, "--wandb (the GPU machine has no wandb; metrics go to "
                            "metrics.jsonl)"),
               (args.multihost, "--multihost"),
               (args.graph_model_name == "GAT", "--graph-model-name GAT")]
    for flag, what in refused:
        if flag:
            p.error(f"{what} is not ported to medtok_tpu_torch (ROADMAP Queue 1)")
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
    args = parse_args(argv)

    import torch

    from medtok_tpu_torch import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.models.bert import convert_hf_bert
    from medtok_tpu_torch.train.trainer import Trainer
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager
    from medtok_tpu_torch.utils.logging import MetricsLogger, create_logger

    cfg = config_from_args(args)
    if args.workdir:
        workdir = Path(args.workdir)
        if (workdir / "args.json").exists():
            # the config-freezing contract: the stored config wins on resume
            cfg = CheckpointManager.load_config(workdir)
    else:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        workdir = Path(args.results_dir) / f"{stamp}-{args.graph_model_name}"
    logger = create_logger(workdir)
    logger.info(f"Experiment directory created at {workdir}")
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    dataset = MedCodeDataset.from_path(
        KnowledgeGraph.from_csv(cfg.data.kg_path), cfg.data.med_codes_pkg_map_path,
        WordPieceTokenizer.from_vocab_file(args.text_vocab), cfg=cfg.data)
    logger.info(f"Dataset contains {len(dataset):,} medical codes")

    metrics_logger = MetricsLogger(workdir)

    def log_fn(step, m):
        metrics_logger.log(step, m)
        logger.info(f"(step={step:07d}) Train Loss: {m.get('loss', float('nan')):.4f}, "
                    f"Train Steps/Sec: {m.get('steps_per_sec', 0):.2f}")

    trainer = Trainer(cfg, device=device, workdir=workdir, log_fn=log_fn)
    state = trainer.init_state()
    if state.step:
        logger.info(f"Resumed from the checkpoint at step {state.step}")
    if args.bert_checkpoint:
        # before anything reads the text encoder
        logger.info(f"Loading BERT weights from {args.bert_checkpoint}")
        sd = torch.load(args.bert_checkpoint, map_location="cpu", weights_only=True)
        trainer.model.text_model.load_state_dict(convert_hf_bert(sd, cfg.model.text))

    t = cfg.train
    steps_per_epoch = len(dataset) // t.global_batch_size
    start_epoch = state.step // max(steps_per_epoch, 1)
    logger.info(f"Training for {t.epochs} epochs from epoch {start_epoch}...")
    for epoch in range(start_epoch, t.epochs):
        logger.info(f"Beginning epoch {epoch}...")
        batches = epoch_batches(dataset, batch_size=t.global_batch_size,
                                seed=t.global_seed, epoch=epoch)
        state = trainer.fit(state, batches, max_steps=args.max_steps)
        if args.max_steps is not None and state.step >= args.max_steps:
            break
    trainer.save(state)
    metrics_logger.close()
    logger.info("Done!")
    return workdir


if __name__ == "__main__":
    main()
