"""The port's training entry point on the CPU: ``Trainer.fit`` over
``epoch_batches`` lowers the loss at the tiny config (as the JAX package's
``test_training_converges_tiny`` asks of its trainer), the cross-attention
dropout of the training view, the trainer's refusals (a mesh above one
device; packed text with BERT dropout) and a step with BERT dropout, and
that ``fit`` draws no batch past ``max_steps``."""

import dataclasses

import numpy as np
import pytest
import torch

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
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.models.layers import CrossAttention, dropout, init_random_
from medtok_tpu_torch.train.trainer import Trainer, trainable_parameters

KG_NODES = 500


def tiny_model(**quant) -> ModelConfig:
    return ModelConfig(
        text=TextEncoderConfig(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                               intermediate_size=64, max_position_embeddings=64),
        graph=GraphEncoderConfig(num_nodes=KG_NODES, in_channels=8, hidden_channels=16,
                                 out_channels=16),
        quantizer=QuantizerConfig(codebook_size=90, codebook_embed_dim=16,
                                  usage_buffer_size=4096, **quant),
        max_text_length=32,
    )


@pytest.fixture(scope="module")
def dataset():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    rng = np.random.default_rng(0)
    cols = synthetic_vocab_columns(rng, num_codes=16, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=12)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=8_000, local_frac=0.8)
    cfg = DataConfig(text_buckets=(8, 16, 32), node_buckets=(8, 16),
                     edge_buckets=(16, 64), max_text_length=32)
    return MedCodeDataset.from_columns(kg, cols, WordPieceTokenizer(vocab), cfg=cfg)


def test_trainer_fit_lowers_the_loss(dataset):
    """40 packed steps over epoch_batches (two batches of 8 an epoch, edge
    dropout on, cross-attention dropout 0.1, bf16 compute) halve the loss."""
    assert len(dataset.tokenizer.vocab) <= 256
    cfg = MedTokConfig(model=tiny_model(), data=dataset.cfg,
                       train=TrainConfig(global_batch_size=8, lr=3e-3, ema=True,
                                         packed_text=True, packed_row_len=64))
    logged = []
    trainer = Trainer(cfg, device="cpu", log_fn=lambda step, m: logged.append((step, m)))
    state = trainer.init_state()
    bert = {k: v.clone() for k, v in trainer.model.text_model.state_dict().items()}

    def batches():
        for epoch in range(100):
            yield from epoch_batches(dataset, batch_size=8, seed=0, epoch=epoch)

    state = trainer.fit(state, batches(), max_steps=40)
    assert state.step == 40 and [s for s, _ in logged] == list(range(1, 41))
    losses = [m["loss"] for _, m in logged]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < 0.5 * np.mean(losses[:4]), losses
    assert all(m["steps_per_sec"] > 0 for _, m in logged)
    assert 0 < logged[-1][1]["codebook_usage_shared"] <= 1
    # the packed row budget was fixed from the first batch
    assert trainer.pack_rows >= 2
    for k, v in trainer.model.text_model.state_dict().items():
        assert torch.equal(v, bert[k]), k
    # fp32 parameters, and an EMA (decay 0.9999) that trails them
    for (name, p), ema in zip(trainable_parameters(trainer.model), state.ema_params):
        assert p.dtype == ema.dtype == torch.float32, name
    codebook = dict(trainable_parameters(trainer.model))["quantize.codebook"]
    names = [n for n, _ in trainable_parameters(trainer.model)]
    assert (state.ema_params[names.index("quantize.codebook")] - codebook).abs().max() > 0


def test_cross_attention_dropout():
    """Dropout 0.5 on the attention probabilities and the attention output,
    switched as flax switches it (``deterministic``, off by default; the
    training forward turns it on): the training output differs from the
    deterministic one, one generator state gives one output, and kept
    values are scaled by 1 / (1 - p)."""
    x = torch.ones(4000)
    kept = dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert 0.2 < float((kept == 0).float().mean()) < 0.3

    attn = init_random_(CrossAttention(16, 4, 2, dropout=0.5),
                        torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    v1 = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    v2 = torch.from_numpy(rng.normal(size=(3, 7, 16)).astype(np.float32))
    m1, m2 = torch.ones(3, 5, dtype=torch.bool), torch.ones(3, 7, dtype=torch.bool)

    def run(seed, **kw):
        with torch.no_grad():
            return attn(v1, v2, m1, m2, generator=torch.Generator().manual_seed(seed), **kw)

    det = run(5)
    for a, b in zip(det, run(6, deterministic=True)):
        assert torch.equal(a, b)
    train, same, other = (run(s, deterministic=False) for s in (5, 5, 6))
    for a, b, c, d in zip(train, same, other, det):
        assert torch.equal(a, b)
        assert not torch.equal(a, c) and not torch.allclose(a, d, atol=1e-3)


def test_trainer_refusals(dataset):
    model = tiny_model()
    cfg = MedTokConfig(model=model, data=dataset.cfg,
                       train=TrainConfig(global_batch_size=8, mesh_dp=2))
    # a (dp, tp) mesh needs a process group of its size, and names its launch
    with pytest.raises(ValueError, match="world size is 1: .*torchrun --nproc-per-node 2"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, mesh_dp=-1, mesh_tp=2)), device="cpu")
    # text dropout trains (unpacked); with packed text it raises
    cfg = MedTokConfig(model=dataclasses.replace(model, text_dropout_in_train=True),
                       data=dataset.cfg, train=TrainConfig(global_batch_size=8))
    logged = []
    trainer = Trainer(cfg, device="cpu", log_fn=lambda step, m: logged.append(m))
    state = trainer.fit(trainer.init_state(), epoch_batches(dataset, batch_size=8),
                        max_steps=1)
    assert state.step == 1 and np.isfinite(logged[0]["loss"])
    packed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, packed_text=True, packed_row_len=32))
    trainer = Trainer(packed_cfg, device="cpu")
    with pytest.raises(ValueError, match="text_dropout_in_train"):
        trainer.fit(trainer.init_state(), epoch_batches(dataset, batch_size=8), max_steps=1)
    cfg = MedTokConfig(model=model, data=dataset.cfg,
                       train=TrainConfig(global_batch_size=8, packed_text=True,
                                         packed_row_len=32, packed_rows_per_shard=1))
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="packed_rows_per_shard"):
        trainer.fit(trainer.init_state(), epoch_batches(dataset, batch_size=8), max_steps=1)


def test_fit_draws_no_batch_past_max_steps(dataset):
    """fit checks ``max_steps`` before it draws the next batch, so a
    collate is never paid for a step that will not run."""
    cfg = MedTokConfig(model=tiny_model(), data=dataset.cfg,
                       train=TrainConfig(global_batch_size=8, packed_text=True,
                                         packed_row_len=64))
    trainer = Trainer(cfg, device="cpu")
    drawn = []

    def batches():
        for epoch in range(10):
            for batch in epoch_batches(dataset, batch_size=8, seed=0, epoch=epoch):
                drawn.append(epoch)
                yield batch

    state = trainer.fit(trainer.init_state(), batches(), max_steps=3)
    assert state.step == 3 and len(drawn) == 3
    state = trainer.fit(state, batches(), max_steps=3)
    assert state.step == 3 and len(drawn) == 3
    # a source that runs out ends the fit early
    state = trainer.fit(state, epoch_batches(dataset, batch_size=8, seed=0))
    assert state.step == 3 + len(dataset) // 8
