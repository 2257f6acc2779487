"""Medical-QA CLI: LoRA finetuning and evaluation of the soft-prompted Llama
(counterpart of ``medtok_tpu/cli/qa.py``).

    python -m medtok_tpu_torch.cli.qa finetune --data medmcqa_dataset.json \
        --embedding-path results/<exp>/embeddings_all.npy \
        --llama-checkpoint <hf-torch-state-dict.pt> --tokenizer-json tokenizer.json
    python -m medtok_tpu_torch.cli.qa eval --data Afrimedqa_dataset.json ...
    torchrun --nproc-per-node 8 -m medtok_tpu_torch.cli.qa finetune ... --mesh-dp 2 --mesh-tp 4

Dataset JSON rows: {"input": [question, answer], "medical_codes": [...]}.
The LLM checkpoint is a HF PyTorch state_dict (``qa.llama.convert_hf_llama``);
with ``--tiny`` a random tiny model runs the whole pipeline and, without
``--tokenizer-json``, a hash tokenizer stands in for the vocabulary.

``finetune`` writes to ``--adapter-path``: ``projector.npy`` (the projector
kernel in the JAX layout [256, H], the transpose of the Linear weight) and
``lora_params.pt`` (``torch.save`` of every trainable tensor by name: the
LoRA adapters, ``lora_a`` [in, r] and ``lora_b`` [r, out], and the
projector), in the one-device layout whatever the mesh. ``eval`` loads no
adapter, as the JAX CLI loads none. Runs on CUDA unless ``--device`` names
another device; without a GPU and without ``--device`` it stops before
reading anything. fp32 matmuls run in full fp32 (TF32 off).

Under ``torchrun`` the run takes a (dp, tp) mesh of the world's ranks, as
``cli.train`` does: ``--mesh-tp T`` ranks split the LLM (Megatron layout,
``qa/sharding.py``), ``--mesh-dp`` blocks (-1: world / T) split each
batch; dp x tp other than the world size is refused at parse time, and so
is any axis above 1 without the launcher. Rank 0 logs and writes the
adapter, its tp-split ``lora_b`` gathered first, so a one-device
``QAFinetuner`` loads it.
"""

from __future__ import annotations

import argparse
import json
import zlib
from pathlib import Path

import numpy as np

from medtok_tpu_torch.utils.platform import apply_platform_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["finetune", "eval"])
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--embedding-path", type=str, required=True)
    p.add_argument("--llama-checkpoint", type=str, default=None)
    p.add_argument("--tokenizer-json", type=str, default=None,
                   help="HF tokenizer.json (Llama byte-level BPE) read by "
                        "qa.tokenizer.BPETokenizer; required without --tiny")
    p.add_argument("--adapter-path", type=str, default="llama_lora_finetune")
    p.add_argument("--tiny", action="store_true",
                   help="random tiny LLM (offline smoke mode)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--mesh-dp", type=int, default=1,
                   help="data-parallel blocks: -1 (world / mesh-tp) or world / mesh-tp")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel ranks of the LLM; divides the world")
    p.add_argument("--lora-r", type=int, default=16)
    p.add_argument("--lora-alpha", type=float, default=32)
    p.add_argument("--cutoff-len", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--num-miss-rows", type=int, default=100)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.4)
    p.add_argument("--top-p", type=float, default=0.9)
    return p


def _simple_tokenize(text: str, vocab_size: int) -> list[int]:
    """Hash-based fallback tokenizer for --tiny mode (no real LLM vocab).
    CRC-32, not ``hash``: every process of a run (the ranks of a mesh) must
    give a word the same id, and ``hash`` of a str is salted per process."""
    return [zlib.crc32(w.encode()) % (vocab_size - 10) + 10 for w in text.split()][:200]


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, the mesh checked against the launcher's world size (an
    argparse error, exit code 2)."""
    from medtok_tpu_torch.parallel.mesh import check_mesh, world_size

    p = build_parser()
    args = p.parse_args(argv)
    try:
        check_mesh(args.mesh_dp, args.mesh_tp, world_size())
    except ValueError as e:
        p.error(f"--mesh-dp {args.mesh_dp} --mesh-tp {args.mesh_tp}: {e}")
    return args


def main(argv=None) -> dict:
    """Run a mode; returns ``{"losses": [...], "adapter_path": ...}`` after
    finetune and ``{"accuracy": ..., "predictions": [...]}`` after eval."""
    apply_platform_env()
    args = parse_args(argv)
    if not args.tiny and not args.tokenizer_json:
        raise SystemExit(
            "--tokenizer-json is required for non --tiny runs "
            "(the 128K-token Llama vocab cannot be faked)"
        )

    import torch
    import torch.distributed as dist

    from medtok_tpu_torch import resolve_device
    from medtok_tpu_torch.parallel.mesh import initialize_distributed, warmup_collectives

    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()   # a group the caller made stays
    mesh = initialize_distributed(device, dp=args.mesh_dp, tp=args.mesh_tp)
    warmup_collectives(mesh)
    rank = 0 if mesh is None else mesh.rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medtok_tpu_torch.qa.finetune import QAFinetuneConfig, QAFinetuner
    from medtok_tpu_torch.qa.inference import evaluate_qa, extend_with_miss_rows
    from medtok_tpu_torch.qa.llama import LLAMA31_8B, TINY_LLAMA, convert_hf_llama
    from medtok_tpu_torch.qa.prompting import build_prompt, pack_example
    from medtok_tpu_torch.qa.sharding import gather_param
    from medtok_tpu_torch.utils.logging import create_logger

    logger = create_logger(None, process_index=rank)
    rows_json = json.loads(Path(args.data).read_text())
    embeddings = extend_with_miss_rows(
        np.load(args.embedding_path), num_miss_rows=args.num_miss_rows
    )

    llm_cfg = TINY_LLAMA if args.tiny else LLAMA31_8B
    total_len = args.cutoff_len + (64 if args.tiny else 256)
    cfg = QAFinetuneConfig(
        lora_rank=args.lora_r, lora_alpha=args.lora_alpha,
        cutoff_len=args.cutoff_len, total_len=total_len,
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs,
        mesh_dp=args.mesh_dp, mesh_tp=args.mesh_tp,
    )
    ft = QAFinetuner(llm_cfg, embeddings, cfg, device=device, dp=mesh)

    llm_params = None
    if args.llama_checkpoint:
        logger.info(f"Converting LLM weights from {args.llama_checkpoint}")
        sd = torch.load(args.llama_checkpoint, map_location="cpu")
        llm_params = convert_hf_llama(sd, ft.llm_cfg)
    ft.init_params(llm_params)

    # the real tokenizer and the Llama-3 chat template; the hash stub only
    # for --tiny runs without a tokenizer file (random vocab anyway)
    if args.tokenizer_json:
        from medtok_tpu_torch.qa.tokenizer import BPETokenizer

        tokenizer = BPETokenizer.from_file(args.tokenizer_json)
        chat_template = tokenizer.chat_template_fn
        eos_id = tokenizer.eos_token_id
        encode = tokenizer.encode

        def decode(ids):
            return tokenizer.decode(ids, skip_special_tokens=True)
    else:
        chat_template, eos_id = None, None

        def encode(text):
            return _simple_tokenize(text, llm_cfg.vocab_size)

        def decode(ids):
            return " ".join(str(i) for i in ids)

    packed, labels = [], []
    for r in rows_json:
        q, a = r["input"][0], r["input"][1]
        prompt = build_prompt(q, chat_template=chat_template)
        if args.mode == "finetune" and chat_template is not None:
            prompt += f"\n{a}"  # the answer inside the rendered prompt
            prompt_ids, answer_ids = encode(prompt), []
        else:
            prompt_ids = encode(prompt)
            answer_ids = encode(str(a)) if args.mode == "finetune" else []
        packed.append(pack_example(
            prompt_ids, answer_ids, r["medical_codes"],
            cutoff_len=args.cutoff_len, eos_token_id=eos_id,
        ))
        labels.append(str(a))

    if args.mode == "finetune":
        logger.info(f"Finetuning on {len(packed)} examples")
        losses = []

        def log_fn(step, loss):
            losses.append(loss)
            logger.info(f"step {step}: loss {loss:.4f}")

        ft.fit(packed, log_fn=log_fn)
        out = Path(args.adapter_path)
        # the one-device layout: every rank of a tp axis takes part in each gather
        adapter = {name: gather_param(name.removeprefix("llm."), p.detach(), ft.model.mesh,
                                      ft.llm_cfg).cpu()
                   for name, p in ft.named_parameters() if p.requires_grad}
        if rank == 0:
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / "projector.npy",
                    ft.soft_prompt.projector.weight.detach().T.cpu().numpy())
            torch.save(adapter, out / "lora_params.pt")
            logger.info(f"Saved adapter to {out}")
        result = {"losses": losses, "adapter_path": out}
    else:
        acc, preds = evaluate_qa(
            ft, packed, labels,
            decode_fn=decode,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_p=args.top_p,
            batch_size=args.batch_size,
        )
        logger.info(f"Accuracy: {acc}")
        result = {"accuracy": acc, "predictions": preds}
    if mesh is not None:
        mesh.barrier()
        if owns_group:
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
