"""End-to-end quickstart of the PyTorch + CUDA port on synthetic data (no
downloads): writes a reference-schema vocabulary and PrimeKG, trains the
tokenizer 5 steps, exports embeddings and tokens, and checks that the live
API (``MedTok``) and the artifact-only API (``PretrainedMedTok``) agree.

    python examples/quickstart_torch.py                # on the GPU (kernels K1, ...)
    python examples/quickstart_torch.py --device cpu   # the plain PyTorch versions

Without a GPU and without ``--device cpu`` it raises. (Real data: point the
CLIs' --kg-path / --med-codes-pkg-map-path at PrimeKG's kg.csv and
all_codes_mappings, and pass a real bert-base-uncased vocab.txt.)
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np  # noqa: E402

from medtok_tpu_torch.utils.platform import apply_platform_env  # noqa: E402

WORDS = ["diabetes", "mellitus", "acute", "chronic", "infection", "fracture",
         "hypertension", "renal", "cardiac", "therapy", "syndrome", "disorder"]


def main(argv=None) -> dict:
    """Run the quickstart; returns the losses, the exported arrays' shapes
    and the largest API difference."""
    apply_platform_env()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--workdir", default=None, help="where the files go (a new temp dir)")
    args = p.parse_args(argv)

    from medtok_tpu_torch import resolve_device
    from medtok_tpu_torch.api import MedTok, PretrainedMedTok
    from medtok_tpu_torch.config import (
        DataConfig,
        GraphEncoderConfig,
        MedTokConfig,
        ModelConfig,
        QuantizerConfig,
        TextEncoderConfig,
        TrainConfig,
    )
    from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches
    from medtok_tpu_torch.data.kg import KnowledgeGraph
    from medtok_tpu_torch.data.synthetic import synthetic_code_vocab, synthetic_kg_csv
    from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
    from medtok_tpu_torch.export import export_all
    from medtok_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="medtok_quickstart_torch_"))
    rng = np.random.default_rng(0)
    (work / "primeKG").mkdir(parents=True, exist_ok=True)
    synthetic_kg_csv(work / "primeKG" / "kg.csv", rng, num_nodes=300, num_edges=2000)
    synthetic_code_vocab(work / "codes.jsonl", rng, num_codes=40, num_nodes=300)
    tokenizer = WordPieceTokenizer(make_test_vocab(WORDS))

    cfg = MedTokConfig(
        model=ModelConfig(
            text=TextEncoderConfig(vocab_size=200, hidden_size=32, num_layers=2,
                                   num_heads=4, intermediate_size=64),
            graph=GraphEncoderConfig(num_nodes=300, in_channels=8,
                                     hidden_channels=16, out_channels=16),
            quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16,
                                      usage_buffer_size=4096),
            compute_dtype="float32",
        ),
        data=DataConfig(kg_path=str(work / "primeKG"),
                        med_codes_pkg_map_path=str(work / "codes.jsonl")),
        train=TrainConfig(global_batch_size=8, mesh_dp=1, ckpt_every=5),
    )
    dataset = MedCodeDataset.from_path(KnowledgeGraph.from_csv(cfg.data.kg_path),
                                       cfg.data.med_codes_pkg_map_path, tokenizer,
                                       cfg=cfg.data)

    print(f"== training 5 steps on {len(dataset)} synthetic codes on {device} ==")
    losses = []

    def log(step, m):
        losses.append(m["loss"])
        print(f"  step {step}: loss {m['loss']:.3f}")

    trainer = Trainer(cfg, device=device, workdir=work / "exp", log_fn=log)
    state = trainer.fit(trainer.init_state(), epoch_batches(dataset, batch_size=8),
                        max_steps=5)
    if state.step != 5 or not np.isfinite(losses).all():
        raise RuntimeError(f"training stopped at step {state.step}, losses {losses}")

    print("== exporting embeddings / tokens ==")
    api = MedTok.from_checkpoint(work / "exp", dataset, device=device)
    arrays = export_all(api.model, dataset, batch_size=8, device=device, out_dir=work / "exp")
    print(f"  embeddings_all {arrays['embeddings_all'].shape}, "
          f"tokens_all {arrays['tokens_all'].shape}")

    code = dataset.code_at(3)
    print(f"== live API on {code!r} ==")
    print(f"  tokens:\n{api.tokenize(code)}")
    print(f"  embedding[:6]: {api.embed(code)[:6]}")

    print("== artifact-only API (published-embeddings path) ==")
    pre = PretrainedMedTok(work / "exp", work / "codes.jsonl")
    diff = float(np.abs(pre.embed(code) - api.embed(code)).max())
    if not diff <= 2e-3:
        raise RuntimeError(f"PretrainedMedTok.embed differs from MedTok.embed by {diff}")
    print(f"  PretrainedMedTok.embed == MedTok.embed for {code!r}: OK ({diff:.2e})")
    print(f"artifacts in {work}")
    return {"losses": losses, "shapes": {k: v.shape for k, v in arrays.items()},
            "api_diff": diff, "workdir": work}


if __name__ == "__main__":
    main()
