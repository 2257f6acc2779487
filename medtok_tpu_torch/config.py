"""Frozen dataclass configs (own copy of ``medtok_tpu/config.py``).

Field names and defaults are the JAX package's, so an ``args.json`` written
by the JAX trainer loads here unchanged through ``MedTokConfig.load``.
``ModelConfig()`` is the full-width model: bert-base 12x768, a GCN
64/128/64 over a 130K-node table and a 21000x64 codebook.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class TextEncoderConfig:
    """BERT-base-uncased shape."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    # block-diagonal segment attention (kernel K2) on the packed path
    packed_flash: bool = True


@dataclass(frozen=True)
class GraphEncoderConfig:
    model_name: str = "GCN"  # "GCN" | "GAT" (GAT is not ported yet)
    num_nodes: int = 130000
    in_channels: int = 64
    hidden_channels: int = 128
    out_channels: int = 64
    gat_num_heads: int = 4


@dataclass(frozen=True)
class QuantizerConfig:
    codebook_size: int = 21000
    codebook_embed_dim: int = 64
    commit_loss_beta: float = 0.25
    entropy_loss_ratio: float = 0.0
    l2_norm: bool = True
    show_usage: bool = True
    top_k: int = 5
    num_heads: int = 4
    cross_attn_layers: int = 2
    cross_attn_dropout: float = 0.1
    usage_buffer_size: int = 300000
    use_kmeans: bool = False
    codebook_ema_decay: float = 0.99
    codebook_revival: bool = False
    # every value routes to kernel K1 on CUDA and to the plain version on CPU
    topk_backend: str = "auto"


@dataclass(frozen=True)
class ModelConfig:
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    graph: GraphEncoderConfig = field(default_factory=GraphEncoderConfig)
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)
    max_text_length: int = 512
    text_dropout_in_train: bool = False
    # compute dtype of the encoders (VQ distances are always fp32)
    compute_dtype: str = "bfloat16"

    @property
    def split(self) -> tuple[int, int]:
        d = self.quantizer.codebook_embed_dim
        return (d, d)

    @property
    def embedding_dim(self) -> int:
        return 4 * self.quantizer.codebook_embed_dim


@dataclass(frozen=True)
class DataConfig:
    kg_path: str = "Dataset/primeKG/"
    med_codes_pkg_map_path: str = "Dataset/medicalCode/all_codes_mappings.parquet"
    text_vocab_path: str = ""
    max_text_length: int = 512
    text_buckets: tuple[int, ...] = (64, 128, 256, 512)
    node_buckets: tuple[int, ...] = (32, 128, 512)
    edge_buckets: tuple[int, ...] = (64, 512, 4096)
    edge_dropout_p: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters; carried for ``args.json`` compatibility
    (the port has no trainer yet)."""

    epochs: int = 50
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 5e-2
    max_grad_norm: float = 1.0
    global_batch_size: int = 1024
    global_seed: int = 0
    log_every: int = 1
    ckpt_every: int = 500
    max_checkpoints: int = 2
    mixed_precision: str = "bf16"
    shared_loss_beta: float = 0.1
    specific_loss_lamb: float = 0.1
    ema: bool = False
    ema_decay: float = 0.9999
    results_dir: str = "results"
    mesh_dp: int = -1
    mesh_tp: int = 1
    packed_text: bool = False
    packed_row_len: int = 128
    packed_rows_per_shard: int = 0


@dataclass(frozen=True)
class MedTokConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MedTokConfig":
        """Build from a nested dict; unknown keys are ignored and lists
        become tuples, as in the JAX package's loader."""

        def build(tp, val):
            if not (dataclasses.is_dataclass(tp) and isinstance(val, dict)):
                return val
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in val.items():
                if k not in fields:
                    continue
                ft = fields[k].type
                name = ft if isinstance(ft, str) else getattr(ft, "__name__", "")
                sub = _TYPE_REGISTRY.get(name)
                if sub is not None and isinstance(v, dict):
                    kwargs[k] = build(sub, v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(v)
                else:
                    kwargs[k] = v
            return tp(**kwargs)

        return build(cls, d)

    @classmethod
    def load(cls, path: str | Path) -> "MedTokConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))


_TYPE_REGISTRY = {
    "ModelConfig": ModelConfig,
    "DataConfig": DataConfig,
    "TrainConfig": TrainConfig,
    "TextEncoderConfig": TextEncoderConfig,
    "GraphEncoderConfig": GraphEncoderConfig,
    "QuantizerConfig": QuantizerConfig,
}
