"""Downstream quickstart of the PyTorch + CUDA port: MedTok embeddings ->
EHR outcomes + medical QA, end to end on synthetic fixtures (no downloads):
EHR readmission on synthetic MIMIC-III tables (the encoder's attention is
kernel K3 on the GPU), then a LoRA soft-prompt finetune and an evaluation of
the tiny Llama.

    python examples/downstream_torch.py                # on the GPU
    python examples/downstream_torch.py --device cpu   # the plain PyTorch versions

Without a GPU and without ``--device cpu`` it raises. (Real data: run
``python -m medtok_tpu_torch.cli.export`` first, then point --embedding-path
of ``cli.ehr`` / ``cli.qa`` at the exported embeddings_all.npy.)
"""

import argparse
import sys
import tempfile
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np  # noqa: E402

from medtok_tpu_torch.utils.platform import apply_platform_env  # noqa: E402


def run_ehr(work: Path, rng: np.random.Generator, device) -> dict:
    from medtok_tpu_torch.data.synthetic import synthetic_code_vocab
    from medtok_tpu_torch.ehr.parsers import MIMIC3Dataset
    from medtok_tpu_torch.ehr.synthetic import synthetic_mimic3
    from medtok_tpu_torch.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels
    from medtok_tpu_torch.ehr.train import (
        EHRTrainConfig,
        EHRTrainer,
        prepare_task_features,
        sample_weights,
        stratified_split,
    )

    print("== EHR: synthetic MIMIC-III readmission ==")
    synthetic_code_vocab(work / "codes.jsonl", rng, num_codes=60, num_nodes=300)
    mapper = CodeMapper(work / "codes.jsonl")
    synthetic_mimic3(work / "MIMIC_III", mapper.med_codes, num_patients=100, seed=2)
    db = MIMIC3Dataset(work / "MIMIC_III")
    tasks = PatientEHRTasks(db.patients, mapper, dataset="MIMIC_III")
    data = [s for s in tasks.build("readmission") if s and s[0]["label"] is not None]
    labels, nc = build_labels(data, "readmission")
    feats, fz = prepare_task_features(data, labels, nc, "readmission",
                                      vocab_size=len(mapper), max_visits=5,
                                      max_medical_code=32)
    tr, va, te = stratified_split(labels, "readmission")
    w = sample_weights(labels, "readmission")

    # stand-in for the exported embeddings_all.npy
    table = rng.standard_normal((len(mapper), 256)).astype(np.float32)
    trainer = EHRTrainer(
        EHRTrainConfig(task="readmission", batch_size=8, epochs=3, num_layers=1,
                       hidden_dim=32, num_heads=2, input_dim=16, output_dim=16,
                       max_visits=5, max_medical_code=32),
        table, nc, device=device)
    val = [fz.collate([feats[i] for i in va])]
    best_state, best = trainer.fit(
        [feats[i] for i in tr], w[tr], val, fz,
        log_fn=lambda e, m: print(f"  epoch {e}: loss {m['loss']:.3f} val {m['val']}"))
    trainer.model.load_state_dict(best_state)
    test = trainer.evaluate([fz.collate([feats[i] for i in te])])
    print(f"  test: {test}")
    if not all(np.isfinite(v) for v in test.values()) or not 0 <= test["auc"] <= 1:
        raise RuntimeError(f"EHR test metrics out of range: {test}")
    return {"samples": len(data), "best_val": best, "test": test}


def run_qa(work: Path, rng: np.random.Generator, device) -> dict:
    from medtok_tpu_torch.qa.finetune import QAFinetuneConfig, QAFinetuner
    from medtok_tpu_torch.qa.inference import evaluate_qa, extend_with_miss_rows
    from medtok_tpu_torch.qa.llama import TINY_LLAMA
    from medtok_tpu_torch.qa.prompting import build_prompt, pack_example

    print("== QA: tiny Llama + LoRA soft-prompt finetune ==")
    emb = extend_with_miss_rows(rng.standard_normal((60, 256)).astype(np.float32),
                                num_miss_rows=10)
    ft = QAFinetuner(TINY_LLAMA, emb,
                     QAFinetuneConfig(lora_rank=2, cutoff_len=8, total_len=40,
                                      batch_size=4, epochs=1),
                     device=device)
    ft.init_params(None)

    def encode(text):  # a CRC-32 hash stub; real runs load a Llama tokenizer.json
        return [zlib.crc32(w.encode()) % 500 + 10 for w in text.split()][:24]

    rows, labels = [], []
    for i in range(8):
        q, a = f"question about code {i}?", "A"
        rows.append(pack_example(encode(build_prompt(q)), encode(a), [i % 60],
                                 cutoff_len=8))
        labels.append(a)
    losses = []
    ft.fit(rows, log_fn=lambda s, l: losses.append(l) or print(f"  step {s}: loss {l:.3f}"))
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise RuntimeError(f"QA finetune losses {losses}")
    acc, preds = evaluate_qa(ft, rows, labels,
                             decode_fn=lambda ids: " ".join(str(i) for i in ids),
                             max_new_tokens=2, batch_size=4)
    print(f"  eval ran on {len(preds)} questions (accuracy vs letter labels: "
          f"{acc:.2f} — random weights)")
    if len(preds) != len(rows):
        raise RuntimeError(f"{len(preds)} predictions for {len(rows)} questions")
    return {"losses": losses, "accuracy": acc}


def main(argv=None) -> dict:
    """Run both pipelines; returns their results."""
    apply_platform_env()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--workdir", default=None, help="where the files go (a new temp dir)")
    args = p.parse_args(argv)

    from medtok_tpu_torch import resolve_device

    device = resolve_device(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="medtok_downstream_torch_"))
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    out = {"ehr": run_ehr(work, rng, device), "qa": run_qa(work, rng, device)}
    print(f"artifacts in {work}")
    return out


if __name__ == "__main__":
    main()
