"""The port's checkpoints and the readers its CLIs use on the card, on the
CPU at the verify recipe's widths (text 32 / 4 heads, codebook 90 x 16,
batch 8):

- the pandas-free KG reader against the JAX package's pandas one;
- the .jsonl and .parquet vocabularies giving equal batches;
- a save, a restore into a fresh Trainer and three more steps against three
  uninterrupted steps, bit for bit at fp32 (parameters, Adam state, EMA,
  usage FIFO, generator state), on the packed and the unpacked route;
- rotation to max_checkpoints, the un-rotated mirror, args.json written
  once.
"""

import dataclasses
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from medtok_tpu.data.kg import KnowledgeGraph as JaxKnowledgeGraph
from medtok_tpu.data.synthetic import synthetic_kg_csv
from medtok_tpu_torch.config import DataConfig, MedTokConfig, TrainConfig
from medtok_tpu_torch.data.dataset import MedCodeDataset, epoch_batches, write_jsonl
from medtok_tpu_torch.data.kg import KnowledgeGraph
from medtok_tpu_torch.data.synthetic import (
    MEDICAL_WORDS,
    SYLLABLES,
    synthetic_kg,
    synthetic_vocab_columns,
)
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab
from medtok_tpu_torch.train.trainer import Trainer, create_train_state
from medtok_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_train_fit import KG_NODES, tiny_model

DATA = DataConfig(text_buckets=(8, 16, 32), node_buckets=(8, 16), edge_buckets=(16, 64),
                  max_text_length=32)


def _tokenizer():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    return WordPieceTokenizer(vocab)


def _columns_and_kg(n_codes=16):
    rng = np.random.default_rng(0)
    cols = synthetic_vocab_columns(rng, num_codes=n_codes, num_kg_nodes=KG_NODES,
                                   max_pkg_nodes=12)
    kg = synthetic_kg(rng, num_nodes=KG_NODES, num_edges=8_000, local_frac=0.8)
    return cols, kg


# ------------------------------------------------------------------ readers --

def _quoted_csv(path):
    """A kg.csv whose name fields hold commas and quotes, the relation
    column before the index columns, and relations in an order that is not
    sorted."""
    rows = ['relation,display_relation,x_name,x_index,y_index,y_name',
            'ppi,ppi,"a, b",3,4,"say ""hi"""',
            'drug_target,target,x,0,9,"1,2,3"',
            'ppi,ppi,y,7,2,z',
            'indication,indication,"q,",1,1,w']
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("which", ["synthetic", "quoted"])
def test_kg_reader_matches_jax_pandas_reader(tmp_path, which):
    path = tmp_path / "kg.csv"
    if which == "synthetic":
        synthetic_kg_csv(str(path), np.random.default_rng(1), num_nodes=500, num_edges=4000)
    else:
        _quoted_csv(path)
    want = JaxKnowledgeGraph.from_csv(tmp_path)      # the directory form
    got = KnowledgeGraph.from_csv(path)              # the file form
    for name in ("edge_src", "edge_dst", "rel_index"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert list(got.rel_vocab.items()) == list(want.rel_vocab.items())
    assert got.num_nodes == want.num_nodes


def test_kg_reader_names_missing_columns(tmp_path):
    (tmp_path / "kg.csv").write_text("x_index,y_index\n1,2\n")
    with pytest.raises(ValueError, match="display_relation"):
        KnowledgeGraph.from_csv(tmp_path)


def test_jsonl_and_parquet_vocabularies_give_equal_batches(tmp_path):
    cols, kg = _columns_and_kg()
    write_jsonl(cols, tmp_path / "codes.jsonl")
    pd.DataFrame({c: cols[c] for c in ("med_code", "desc", "pkg_index_list")}).to_parquet(
        tmp_path / "codes.parquet")
    tok = _tokenizer()
    a, b = (MedCodeDataset.from_path(kg, tmp_path / f"codes.{s}", tok, cfg=DATA)
            for s in ("jsonl", "parquet"))
    assert a.med_codes == b.med_codes == list(cols["med_code"]) and a.descs == b.descs
    for x, y in zip(a.make_batch(range(len(a)), aug_seed=3),
                    b.make_batch(range(len(b)), aug_seed=3)):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match=".parquet or a .jsonl"):
        MedCodeDataset.from_path(kg, tmp_path / "codes.csv", tok, cfg=DATA)


# ----------------------------------------------------------- checkpoints --

@pytest.fixture(scope="module")
def dataset():
    cols, kg = _columns_and_kg()
    return MedCodeDataset.from_columns(kg, cols, _tokenizer(), cfg=DATA)


def _cfg(packed: bool, **train) -> MedTokConfig:
    """fp32 compute, cross-attention dropout on (the generator matters),
    the EMA on, a checkpoint every 2 steps."""
    model = dataclasses.replace(tiny_model(), compute_dtype="float32")
    return MedTokConfig(model=model, data=DATA, train=TrainConfig(
        global_batch_size=8, lr=3e-3, ema=True, packed_text=packed, packed_row_len=64,
        ckpt_every=2, **train))


def _batches(dataset, n):
    out = []
    for epoch in range(n):
        out.extend(epoch_batches(dataset, batch_size=8, seed=0, epoch=epoch))
    return out[:n]


def _snapshot(trainer, state) -> dict:
    """Every tensor a run carries, copied."""
    model = state.model
    return {"step": state.step,
            "model": {k: v.clone() for k, v in model.state_dict().items()},
            "buffers": {k: v.clone() for k, v in model.named_buffers()},
            "count": state.opt_state.count,
            "mu": [t.clone() for t in state.opt_state.mu],
            "nu": [t.clone() for t in state.opt_state.nu],
            "ema": [t.clone() for t in state.ema_params],
            "generator": state.generator.get_state().clone(),
            "pack_rows": trainer.pack_rows}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            assert x.keys() == y.keys(), key
            for k in x:
                assert torch.equal(x[k], y[k]), f"{key}.{k}"
        elif isinstance(x, list):
            assert len(x) == len(y) and all(map(torch.equal, x, y)), key
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        else:
            assert x == y, key


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_restore_then_three_steps_equals_three_uninterrupted_steps(dataset, tmp_path, packed):
    cfg = _cfg(packed)
    batches = _batches(dataset, 5)
    live = Trainer(cfg, device="cpu", workdir=tmp_path / "a")
    state = live.fit(live.init_state(), batches[:2])
    assert state.step == 2 and live.ckpt.steps() == [2]
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    state = live.fit(state, batches[2:])
    want = _snapshot(live, state)

    resumed = Trainer(cfg, device="cpu", workdir=tmp_path / "b")
    again = resumed.init_state()
    assert again.step == 2 and resumed.pack_rows == live.pack_rows
    again = resumed.fit(again, batches[2:])
    got = _snapshot(resumed, again)
    _assert_bitwise(got, want)
    # the run moved the usage FIFO and the trainable parameters
    assert any(v.any() for v in got["buffers"].values())
    assert got["count"] == 5


def test_rotation_keeps_max_checkpoints_and_the_mirror_keeps_all(dataset, tmp_path):
    cfg = _cfg(True, max_checkpoints=2)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2, config=cfg,
                            mirror_dir=tmp_path / "mirror")
    for step in (1, 2, 3, 4):
        state.step = step
        mgr.save(state, pack_rows=7)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "run" / "checkpoints").iterdir()) == \
        ["0000003.pt", "0000004.pt"]
    assert sorted(p.name for p in (tmp_path / "mirror").iterdir()) == \
        [f"{s:07d}.pt" for s in (1, 2, 3, 4)]
    # args.json is written once: a second manager with another config keeps it
    CheckpointManager(tmp_path / "run", config=_cfg(False))
    assert CheckpointManager.load_config(tmp_path / "run") == cfg
    # a checkpoint is plain containers and tensors
    ck = torch.load(mgr.path(3), weights_only=True)
    assert ck["step"] == 3 and ck["pack_rows"] == 7
    assert set(ck) == {"step", "model", "buffers", "adam", "ema", "generator", "pack_rows"}
    fresh = create_train_state(cfg, Trainer(cfg, device="cpu").model)
    restored, rows = mgr.restore(fresh, step=3)
    assert restored.step == 3 and rows == 7
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").load()


def test_checkpoint_stores_each_tensor_once_and_reading_writes_nothing(tmp_path):
    cfg = _cfg(True)
    state = Trainer(cfg, device="cpu").init_state()
    mgr = CheckpointManager(tmp_path / "run", config=cfg)
    assert not mgr.ckpt_dir.exists()  # made by the first save
    ck = torch.load(mgr.save(state, pack_rows=3), weights_only=True)
    # the extra buffers are only those the state_dict leaves out: the usage FIFO
    assert ck["buffers"] and set(ck["buffers"]).isdisjoint(ck["model"])
    assert set(ck["model"]) | set(ck["buffers"]) == \
        {n for n, _ in state.model.named_parameters()} | \
        {n for n, _ in state.model.named_buffers()}
    # a reader of a mistyped workdir fails and leaves no directory behind
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "typo").load()
    with pytest.raises(FileNotFoundError):
        CheckpointManager.load_config(tmp_path / "typo")
    assert not (tmp_path / "typo").exists()
