"""Medical QA (counterpart of ``medtok_tpu/qa/``): the soft-prompted Llama
with LoRA, its KV-cache ``generate``, the QA finetuner and evaluation, a
byte-level BPE tokenizer that needs no ``regex`` package, and the host
helpers (prompts, templates, datasets, code extraction and mapping,
streaming). No kernel is on this path: attention is plain torch ops, as
the JAX model's is plain XLA ops."""
