"""Full-vocabulary export CLI (sequence-packed sweep).

    python -m medtok_tpu_torch.cli.export --config args.json \
        --params params.npz --kg primeKG/ --codes codes.parquet \
        --vocab vocab.txt [--device cuda] [--out-dir DIR]

Writes embeddings_all.npy / tokens_all.npy / weights_all.npy in vocabulary
order. Runs on CUDA unless ``--device`` names another device; without a GPU
and without ``--device`` it stops before loading anything. fp32 matmuls and
convolutions run in full fp32 (TF32 off), so fp32 exports stay comparable
with the JAX package's.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="args.json of the model")
    p.add_argument("--params", required=True, help="/-keyed params .npz")
    p.add_argument("--kg", required=True, help="kg.csv or its directory")
    p.add_argument("--codes", required=True, help="all_codes_mappings parquet")
    p.add_argument("--vocab", required=True, help="WordPiece vocab.txt")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)

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
    from medtok_tpu_torch.export import export_all_packed
    from medtok_tpu_torch.models.tokenizer_model import MultimodalTokenizer

    cfg = MedTokConfig.load(args.config)
    dataset = MedCodeDataset.from_parquet(
        KnowledgeGraph.from_csv(args.kg), args.codes,
        WordPieceTokenizer.from_vocab_file(args.vocab), cfg=cfg.data,
    )
    model = load_params(MultimodalTokenizer(cfg.model, device=device), args.params)
    t0 = time.perf_counter()
    arrays = export_all_packed(model, dataset, device=device, out_dir=args.out_dir)
    dt = time.perf_counter() - t0
    n = len(dataset)
    print(f"exported {n} codes in {dt:.2f} s ({n / dt:.0f} codes/s) on "
          f"{device} -> {args.out_dir}")
    for name, arr in arrays.items():
        print(f"  {name}: {arr.shape} {arr.dtype}")


if __name__ == "__main__":
    main()
