"""EHR outcome model (counterpart of ``medtok_tpu/ehr/``): featurizer,
model and trainer. The frozen MedTok export (``embeddings_all``) is the
model's code-embedding table."""
