"""Full-vocabulary export CLI.

    python -m medtok_tpu_torch.cli.export --workdir results/<experiment> \
        [--packed on|off] [--batch-size 1024] [--device cuda] [--out-dir DIR]
    python -m medtok_tpu_torch.cli.export --config args.json \
        --params params.npz --kg primeKG/ --codes codes.jsonl \
        --vocab vocab.txt [--packed on|off] [--batch-size 1024] \
        [--device cuda] [--out-dir DIR]

``--workdir`` reads a training run of the port: its args.json, its latest
checkpoint and the data paths of ``args.json``'s data section (the JAX
CLI's contract); the output goes to the workdir unless ``--out-dir`` names
another. The second form takes a config, a ``/``-keyed params .npz and the
data paths. ``--packed on`` (the default) runs the sequence-packed sweep,
``off`` the unpacked one in batches of ``--batch-size`` codes (the packed
sweep takes no batch size). The vocabulary is a ``.parquet`` (needs pandas) or a ``.jsonl``
copy of its columns; the KG is read without pandas. Writes
embeddings_all.npy / tokens_all.npy / weights_all.npy in vocabulary order.
Runs on CUDA unless ``--device`` names another device; without a GPU and
without ``--device`` it stops before loading anything. One device:
``--mesh-dp`` (the JAX CLI's flag) takes -1 or 1; above 1 raises. fp32
matmuls and convolutions run in full fp32 (TF32 off), so fp32 exports stay
comparable with the JAX package's.
"""

from __future__ import annotations

import argparse
import time

_FILES = ("config", "params", "kg", "codes", "vocab")


def main(argv=None) -> dict:
    """Export; returns the arrays written."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", help="training workdir of the port (args.json + "
                                     "checkpoints/)")
    p.add_argument("--config", help="args.json of the model")
    p.add_argument("--params", help="/-keyed params .npz")
    p.add_argument("--kg", help="kg.csv or its directory")
    p.add_argument("--codes", help="code vocabulary, .parquet or .jsonl")
    p.add_argument("--vocab", help="WordPiece vocab.txt")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="codes a batch of the unpacked sweep")
    p.add_argument("--packed", default="on", choices=["on", "off"],
                   help="sequence-packed text encoder (the default) or the unpacked "
                        "sweep; the outputs agree but for fp32 ties")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--mesh-dp", type=int, default=-1,
                   help="-1 or 1: one device; above 1 raises (the data-parallel export "
                        "is not ported)")
    p.add_argument("--out-dir", default=None, help="default: the workdir, or '.'")
    args = p.parse_args(argv)
    given = [f for f in _FILES if getattr(args, f) is not None]
    if args.workdir is not None and given:
        p.error("--workdir takes the model and data paths from the workdir; drop --"
                + ", --".join(given))
    if args.workdir is None and len(given) < len(_FILES):
        p.error("give --workdir, or all of --" + ", --".join(_FILES))
    if args.mesh_dp > 1:
        raise NotImplementedError(f"mesh_dp={args.mesh_dp}: the export runs on one device "
                                  "(the data-parallel export is not ported)")

    import torch

    from medtok_tpu_torch import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.convert import load_params
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.export import export_all
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager, load_weights

    if args.workdir is not None:
        cfg = CheckpointManager.load_config(args.workdir)
        kg, codes, vocab = (cfg.data.kg_path, cfg.data.med_codes_pkg_map_path,
                            cfg.data.text_vocab_path)
        mgr = CheckpointManager(args.workdir)
        model = load_weights(MultimodalTokenizer(cfg.model, device=device),
                             mgr.load(map_location=device))
        print(f"restored the checkpoint at step {mgr.latest_step()} of {args.workdir}")
        out_dir = args.out_dir or args.workdir
    else:
        cfg = MedTokConfig.load(args.config)
        kg, codes, vocab = args.kg, args.codes, args.vocab
        model = load_params(MultimodalTokenizer(cfg.model, device=device), args.params)
        out_dir = args.out_dir or "."
    dataset = MedCodeDataset.from_path(KnowledgeGraph.from_csv(kg), codes,
                                       WordPieceTokenizer.from_vocab_file(vocab),
                                       cfg=cfg.data)
    t0 = time.perf_counter()
    arrays = export_all(model, dataset, batch_size=args.batch_size,
                        packed=args.packed == "on", device=device, out_dir=out_dir)
    dt = time.perf_counter() - t0
    n = len(dataset)
    print(f"exported {n} codes ({'packed' if args.packed == 'on' else 'unpacked'}) in "
          f"{dt:.2f} s ({n / dt:.0f} codes/s) on {device} -> {out_dir}")
    for name, arr in arrays.items():
        print(f"  {name}: {arr.shape} {arr.dtype}")
    return arrays


if __name__ == "__main__":
    main()
