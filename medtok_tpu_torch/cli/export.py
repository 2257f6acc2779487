"""Full-vocabulary export CLI.

    python -m medtok_tpu_torch.cli.export --workdir results/<experiment> \
        [--packed on|off] [--batch-size 1024] [--device cuda] [--out-dir DIR]
    python -m medtok_tpu_torch.cli.export --config args.json \
        --params params.npz --kg primeKG/ --codes codes.jsonl \
        --vocab vocab.txt [--packed on|off] [--batch-size 1024] \
        [--device cuda] [--out-dir DIR]
    torchrun --nproc-per-node N -m medtok_tpu_torch.cli.export ... --mesh-dp -1

``--workdir`` reads a training run of the port: its args.json, its latest
checkpoint and the data paths of ``args.json``'s data section (the JAX
CLI's contract); the output goes to the workdir unless ``--out-dir`` names
another. The second form takes a config, a ``/``-keyed params .npz and the
data paths: a model trained by the JAX package is exported this way, its
workdir's args.json as ``--config`` and the .npz that
``scripts/jax_workdir_to_npz.py`` writes from its orbax checkpoint as
``--params``. ``--packed on`` (the default) runs the sequence-packed sweep,
``off`` the unpacked one in batches of ``--batch-size`` codes (the packed
sweep takes no batch size). The vocabulary is a ``.parquet`` (needs pandas) or a ``.jsonl``
copy of its columns; the KG is read without pandas. Writes
embeddings_all.npy / tokens_all.npy / weights_all.npy in vocabulary order.
Runs on CUDA unless ``--device`` names another device; without a GPU and
without ``--device`` it stops before loading anything. fp32 matmuls and
convolutions run in full fp32 (TF32 off), so fp32 exports stay comparable
with the JAX package's.

Data parallel: under ``torchrun`` every rank runs on ``cuda:LOCAL_RANK``
over NCCL (on the CPU over gloo with ``--device cpu``) and exports its share
of the steps (``export.py``); rank 0 prints, and writes the arrays, which
are bitwise the one-device export's. ``--mesh-dp`` (the JAX CLI's flag) is
-1 (the world size) or the world size; without a launcher, above 1 is an
error that names the torchrun line.
"""

from __future__ import annotations

import argparse
import time

from medtok_tpu_torch.utils.platform import apply_platform_env

_FILES = ("config", "params", "kg", "codes", "vocab")


def main(argv=None) -> dict:
    """Export; returns the arrays written."""
    apply_platform_env()
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
                   help="data-parallel ranks: -1 (the world size) or the world size; "
                        "above 1 needs torchrun")
    p.add_argument("--out-dir", default=None, help="default: the workdir, or '.'")
    args = p.parse_args(argv)
    given = [f for f in _FILES if getattr(args, f) is not None]
    if args.workdir is not None and given:
        p.error("--workdir takes the model and data paths from the workdir; drop --"
                + ", --".join(given))
    if args.workdir is None and len(given) < len(_FILES):
        p.error("give --workdir, or all of --" + ", --".join(_FILES))
    from medtok_tpu_torch.parallel.mesh import (
        check_mesh,
        initialize_distributed,
        warmup_collectives,
        world_size,
    )

    try:
        check_mesh(args.mesh_dp, 1, world_size())
    except ValueError as e:
        p.error(f"--mesh-dp {args.mesh_dp}: {e}")

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch import resolve_device

    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()   # a group the caller made stays
    dp = initialize_distributed(device, dp=args.mesh_dp)
    warmup_collectives(dp)      # the group's connections, before the gather times
    rank = 0
    if dp is not None:
        device, rank = dp.device, dp.rank

    def say(msg: str) -> None:
        if rank == 0:
            print(msg)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medtok_tpu_torch.config import MedTokConfig
    from medtok_tpu_torch.convert import load_params
    from medtok_tpu_torch.data.dataset import MedCodeDataset
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.text import WordPieceTokenizer
    from medtok_tpu_torch.export import export_all, last_gather
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer
    from medtok_tpu_torch.ops.flash_attention import packed_segment_attention
    from medtok_tpu_torch.ops.topk_l2 import fused_topk_l2
    from medtok_tpu_torch.utils.checkpoint import CheckpointManager, load_weights

    if args.workdir is not None:
        cfg = CheckpointManager.load_config(args.workdir)
        kg, codes, vocab = (cfg.data.kg_path, cfg.data.med_codes_pkg_map_path,
                            cfg.data.text_vocab_path)
        mgr = CheckpointManager(args.workdir)
        model = load_weights(MultimodalTokenizer(cfg.model, device=device),
                             mgr.load(map_location=device))
        say(f"restored the checkpoint at step {mgr.latest_step()} of {args.workdir}")
        out_dir = args.out_dir or args.workdir
    else:
        cfg = MedTokConfig.load(args.config)
        kg, codes, vocab = args.kg, args.codes, args.vocab
        model = load_params(MultimodalTokenizer(cfg.model, device=device), args.params)
        out_dir = args.out_dir or "."
    dataset = MedCodeDataset.from_path(KnowledgeGraph.from_csv(kg), codes,
                                       WordPieceTokenizer.from_vocab_file(vocab),
                                       cfg=cfg.data)
    kernels = (fused_topk_l2, packed_segment_attention)
    before = [f.launches for f in kernels]
    t0 = time.perf_counter()
    arrays = export_all(model, dataset, batch_size=args.batch_size,
                        packed=args.packed == "on", device=device, out_dir=out_dir, dp=dp)
    dt = time.perf_counter() - t0
    n = len(dataset)
    world = 1 if dp is None else dp.world
    say(f"exported {n} codes ({'packed' if args.packed == 'on' else 'unpacked'}) in "
        f"{dt:.3f} s ({n / dt:.0f} codes/s) on {device}, world size {world} -> {out_dir}")
    if dp is not None:
        # each rank's kernel launches: K1 four a step, K2 twelve a packed step
        launches = dp.all_gather_object([f.launches - b for f, b in zip(kernels, before)])
        say(f"  data parallel: {world} ranks over {dp.backend}, the gather "
            f"{last_gather['seconds']:.3f} s for {last_gather['bytes']} bytes; launches "
            "(K1, K2) by rank " + " ".join(f"{r}:{k1},{k2}"
                                           for r, (k1, k2) in enumerate(launches)))
        if owns_group:
            dist.destroy_process_group()
    for name, arr in arrays.items():
        say(f"  {name}: {arr.shape} {arr.dtype}")
    return arrays


if __name__ == "__main__":
    main()
